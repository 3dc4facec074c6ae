"""Carry JAX variables into the port's modules.

``from_jax_variables`` turns the variables tree of a flax model of the JAX
package (``params`` plus the ``quant`` / ``quant_est`` site state), given as
nested dicts of numpy arrays, into a ``state_dict`` for the counterpart
module here. The layouts already agree (``(in, out)`` dense kernels,
``(*K, I, O)`` conv kernels), so the bridge is a rename: flax paths joined
with dots, with the per-site ``q`` / ``est`` dict levels dropped, because a
QuantSite keeps both states as its own buffers (the estimator's under its
state keys: ``xmin``/``xmax`` of the min/max estimators, ``search_grid``
with ``mses`` (MSE) or ``losses`` (cross-entropy) of the searches, and
``count``). The ``quant_cache``
collection (cached quantized weights and packed codes) maps onto the
layers' cache buffers of the same names (``ops.layers.CACHE_KEYS``), and
``batch_stats`` (a BN layer's running ``mean`` and ``var``) onto
``BNQuantConv``'s buffers. The ViT, the Llama models (``embed``,
``layer_{i}``, ``k_cache_quantizer``, ...) and the CNNs (``features_{i}``,
``layer{l}_{b}``, ``downsample_0``, ...) carry across alike.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

# collection -> the dict level that holds one site's state in it
_SITE_LEVEL = {"params": None, "quant": "q", "quant_est": "est", "quant_cache": None,
               "batch_stats": None}


def _flatten(tree: Mapping, prefix, drop, out: Dict[str, torch.Tensor]):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            is_site = key == drop and not any(isinstance(v, Mapping) for v in value.values())
            _flatten(value, prefix if is_site else prefix + [key], drop, out)
        else:
            out[".".join(prefix + [key])] = _tensor(np.array(value))


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bfloat16 (``ml_dtypes``, which numpy cannot name)
    through its bits."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "quant": ..., "quant_est": ..., "quant_cache": ...,
    "batch_stats": ...}`` of numpy arrays -> ``state_dict``. Other
    collections have no counterpart in the port yet and raise."""
    extra = set(variables) - set(_SITE_LEVEL)
    if extra:
        raise NotImplementedError(
            f"collections {sorted(extra)} have no counterpart in the port yet")
    out: Dict[str, torch.Tensor] = {}
    for coll, drop in _SITE_LEVEL.items():
        if coll in variables:
            _flatten(variables[coll], [], drop, out)
    return out
