"""Range estimators as state-update functions (port of
``quant/estimators.py``: ``current_minmax`` and ``allminmax``; the others
belong to a later slice).

``update`` returns ``(state, ranges)`` with ranges ``(x_min, x_max, None)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .. import LATER as _LATER
from ..config import EstimatorConfig, QuantizerConfig, RangeMethod

EstState = Dict[str, torch.Tensor]
Ranges = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]

_PORTED = (RangeMethod.current_minmax, RangeMethod.allminmax)


def _require_ported(cfg: EstimatorConfig):
    if cfg.method not in _PORTED:
        raise NotImplementedError(f"the {cfg.method.value} estimator {_LATER}")
    if cfg.percentile:
        raise NotImplementedError(f"percentile range estimation {_LATER}")


def _channelize(x, per_channel: bool, channel_axis: int):
    """Flatten to (C, -1) with the channel axis leading, or (1, -1)."""
    if per_channel:
        x = torch.movedim(x, channel_axis, 0)
        return x.reshape(x.shape[0], -1)
    return x.reshape(1, -1)


def init(cfg: EstimatorConfig, qcfg: QuantizerConfig, num_channels: int,
         device=None) -> EstState:
    """The zero state for ``num_channels`` channels (1 when per-tensor)."""
    del qcfg
    _require_ported(cfg)
    return {
        "xmin": torch.full((num_channels,), torch.inf, device=device),
        "xmax": torch.full((num_channels,), -torch.inf, device=device),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def update(cfg: EstimatorConfig, qcfg: QuantizerConfig, state: EstState, x,
           per_channel: bool, channel_axis: int = 0) -> Tuple[EstState, Ranges]:
    """Fold one batch into the state; return updated state + current ranges."""
    del qcfg
    _require_ported(cfg)
    xf = _channelize(x, per_channel, channel_axis)
    x_min = xf.amin(dim=-1)
    x_max = xf.amax(dim=-1)
    if cfg.method == RangeMethod.allminmax:
        x_min = torch.minimum(state["xmin"], x_min)
        x_max = torch.maximum(state["xmax"], x_max)
    new = {"xmin": x_min, "xmax": x_max, "count": state["count"] + 1}
    return new, (x_min, x_max, None)
