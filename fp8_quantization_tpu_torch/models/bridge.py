"""Carry JAX variables into the port's modules.

``from_jax_variables`` turns the variables tree of a flax model of the JAX
package (``params`` plus the ``quant`` / ``quant_est`` site state), given as
nested dicts of numpy arrays, into a ``state_dict`` for the counterpart
module here. The layouts already agree (``(in, out)`` dense kernels,
``(*K, I, O)`` conv kernels), so the bridge is a rename: flax paths joined
with dots, with the per-site ``q`` / ``est`` dict levels dropped, because a
QuantSite keeps both states as its own buffers.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

# collection -> the dict level that holds one site's state in it
_SITE_LEVEL = {"params": None, "quant": "q", "quant_est": "est"}


def _flatten(tree: Mapping, prefix, drop, out: Dict[str, torch.Tensor]):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            is_site = key == drop and not any(isinstance(v, Mapping) for v in value.values())
            _flatten(value, prefix if is_site else prefix + [key], drop, out)
        else:
            out[".".join(prefix + [key])] = torch.from_numpy(np.array(value))


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "quant": ..., "quant_est": ...}`` of numpy arrays ->
    ``state_dict``. Collections other than these three have no counterpart in
    this slice and raise."""
    extra = set(variables) - set(_SITE_LEVEL)
    if extra:
        raise NotImplementedError(
            f"collections {sorted(extra)} have no counterpart in the port yet")
    out: Dict[str, torch.Tensor] = {}
    for coll, drop in _SITE_LEVEL.items():
        if coll in variables:
            _flatten(variables[coll], [], drop, out)
    return out
