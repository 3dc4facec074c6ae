"""ExMy mini-float format descriptors (port of ``numerics/formats.py``).

A format is ``E{expo_width}M{mant_width}`` with an exponent ``bias``:

* normal value:    ``(-1)^s * 2^(e - bias) * (1 + m / 2^mant_width)``, e in [1, 2^E-1]
* subnormal value: ``(-1)^s * 2^(1 - bias) * (m / 2^mant_width)``,     e == 0
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def default_bias(expo_width: int) -> int:
    """IEEE-style default bias ``2^(E-1) - 1``."""
    return (1 << (expo_width - 1)) - 1


@dataclasses.dataclass(frozen=True)
class ExMy:
    """Static description of an ExMy mini-float format with a custom bias."""

    expo_width: int
    mant_width: int
    bias: int

    @classmethod
    def create(cls, expo_width: int, mant_width: int, bias: Optional[int] = None) -> "ExMy":
        if bias is None:
            bias = default_bias(expo_width)
        return cls(expo_width=expo_width, mant_width=mant_width, bias=int(bias))

    @property
    def total_bits(self) -> int:
        return 1 + self.expo_width + self.mant_width

    @property
    def max_expo(self) -> int:
        return (1 << self.expo_width) - 1

    @property
    def max_mant(self) -> int:
        return (1 << self.mant_width) - 1

    @property
    def mant_scale(self) -> int:
        return 1 << self.mant_width

    @property
    def max_norm(self) -> float:
        return (2.0 ** (self.max_expo - self.bias)) * (2.0 - 2.0 ** (-self.mant_width))

    @property
    def min_norm(self) -> float:
        return 2.0 ** (1 - self.bias)

    @property
    def min_subnorm(self) -> float:
        return (2.0 ** (1 - self.bias)) * 2.0 ** (-self.mant_width)

    @property
    def max_norm_int(self) -> int:
        """Largest ``(expo << mant_width | mant)`` code."""
        return (1 << (self.expo_width + self.mant_width)) - 1

    @property
    def of_uf_mod(self) -> int:
        """Adder wrap-around modulus for hardware OF/UF simulation."""
        return 1 << (self.expo_width + self.mant_width)

    def with_bias(self, bias: int) -> "ExMy":
        return dataclasses.replace(self, bias=int(bias))


E4M3 = ExMy.create(4, 3)
E3M4 = ExMy.create(3, 4)
E2M5 = ExMy.create(2, 5)
E5M2 = ExMy.create(5, 2)
