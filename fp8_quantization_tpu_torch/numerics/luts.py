"""Mantissa-product error-compensation LUT registry (port of
``numerics/luts.py``).

The six hand-derived int8 tables are data, stored bit-exactly in this
package's own ``_comp_tables.npz``. Tables are 2^M x 2^M, indexed by the two
operands' mantissa fields.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_NPZ = os.path.join(os.path.dirname(__file__), "_comp_tables.npz")


@functools.lru_cache(maxsize=None)
def _tables():
    with np.load(_NPZ) as data:
        return tuple(data[f"table{i}"].astype(np.int32) for i in range(6))


def get_error_table(expo_width: int, mant_width: int, with_comp: bool,
                    dnsmp_factor: int = 3) -> np.ndarray:
    """The residual mantissa-product error table of a format: the table the
    simulated hardware leaves after its own compensation, so e.g. E3M4 with a
    down-sample factor >= 4 compensates perfectly and the table is all zeros.

    Returns a fresh int32 array of shape (2^M, 2^M).
    """
    tabs = _tables()
    zeros = np.zeros((1 << mant_width, 1 << mant_width), dtype=np.int32)

    if (expo_width, mant_width) == (4, 3):
        return zeros if with_comp else tabs[0].copy()
    if (expo_width, mant_width) == (3, 4):
        if with_comp:
            if dnsmp_factor == 3:
                return tabs[1].copy()
            if dnsmp_factor >= 4:
                return zeros
            raise ValueError(f"unsupported dnsmp_factor={dnsmp_factor} for E3M4")
        return tabs[2].copy()
    if (expo_width, mant_width) == (2, 5):
        if with_comp:
            if dnsmp_factor == 3:
                return tabs[3].copy()
            if dnsmp_factor == 4:
                return tabs[4].copy()
            if dnsmp_factor == 5:
                return zeros
            raise ValueError(f"unsupported dnsmp_factor={dnsmp_factor} for E2M5")
        return tabs[5].copy()

    raise ValueError(
        f"Invalid combination of expo_width={expo_width} and mant_width={mant_width}"
    )
