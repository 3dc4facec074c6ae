"""Range estimators as state-update functions (port of
``quant/estimators.py``).

* ``current_minmax`` (optionally a percentile range), ``allminmax`` and
  ``running_minmax``;
* ``MSE``: the FP8 grid search over (mantissa_bits, maxval) candidates of
  "FP8 Quantization: The Power of the Exponent", with the mantissa width
  elected per tensor when ``mse_include_mantissa_bits``;
* ``cross_entropy``: a per-tensor threshold search for logits, scored by
  the cross-entropy between ``softmax(x)`` and ``log_softmax(x_q)``;
* :func:`line_search_ranges`, the 1-D threshold search of the analytic
  error tools (grid or golden section).

``update`` returns ``(state, ranges)`` with ranges ``(x_min, x_max,
mantissa_bits | None)``: only MSE elects a mantissa width.

The searches quantize a whole chunk of candidates in one broadcast pass, as
the JAX package ``vmap``s over the candidate axis; a chunk holds at most
``CHUNK_BYTES`` of f32 values. Sums run in PyTorch's order, so per-candidate
errors agree with the JAX package's to float rounding, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..config import EstimatorConfig, OptMethod, QuantizerConfig, RangeMethod
from ..numerics.fp8_ste import quantize_to_fp8_widths

EstState = Dict[str, torch.Tensor]
Ranges = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]

# the f32 bytes of one broadcast (candidates, ...) tensor in a search
CHUNK_BYTES = 1 << 28

_MINMAX = (RangeMethod.current_minmax, RangeMethod.allminmax, RangeMethod.running_minmax)


def _channelize(x, per_channel: bool, channel_axis: int):
    """Flatten to (C, -1) with the channel axis leading, or (1, -1)."""
    if per_channel:
        x = torch.movedim(x, channel_axis, 0)
        return x.reshape(x.shape[0], -1)
    return x.reshape(1, -1)


def _chunk(per_candidate_elements: int) -> int:
    """Candidates a search quantizes at once."""
    return max(1, CHUNK_BYTES // (4 * max(1, per_candidate_elements)))


def _mbit_list(qcfg: QuantizerConfig):
    """Candidate mantissa widths of the MSE search: 1 .. n_bits - sign - 1,
    with the sign width implied by ``allow_unsigned``, or the static width."""
    if qcfg.fp8.mse_include_mantissa_bits:
        sign_bits = 0 if qcfg.fp8.allow_unsigned else 1
        return [float(m) for m in range(1, qcfg.n_bits - sign_bits)]
    return [float(qcfg.fp8.mantissa_bits)]


def _search_linspace(start, stop, num: int):
    """``jnp.linspace(start, stop, num)`` over vector endpoints, (num, C), as
    XLA's CPU backend evaluates it: ``step = i * f32(1 / (num - 1))`` and
    ``start * (1 - step) + stop * step`` with the ``stop * step`` product
    rounded and one rounding after the fused multiply-add. The FMA is
    exact in f64 here (a 48-bit product plus an f32 of the same sign), and
    one cast rounds it once; the last entry is ``stop``."""
    start = start.to(torch.float32)
    stop = stop.to(torch.float32)
    if num == 1:
        return start[None]
    i = torch.arange(num - 1, dtype=torch.float32, device=start.device)
    step = (i * torch.tensor(1.0 / (num - 1), dtype=torch.float32))[:, None]
    head = ((start[None].double() * (1 - step).double() + (stop[None] * step).double())
            .to(torch.float32))
    return torch.cat([head, stop[None]])


def init(cfg: EstimatorConfig, qcfg: QuantizerConfig, num_channels: int, device=None, *,
         per_channel: bool = False) -> EstState:
    """The zero state for ``num_channels`` channels (1 when per-tensor)."""
    c = num_channels
    if cfg.method in _MINMAX:
        return {
            "xmin": torch.full((c,), torch.inf, device=device),
            "xmax": torch.full((c,), -torch.inf, device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }
    if cfg.method == RangeMethod.MSE:
        n_mbits = len(_mbit_list(qcfg))
        return {
            "search_grid": torch.zeros((cfg.num_candidates, c), device=device),
            "mses": torch.zeros((n_mbits, cfg.num_candidates, c), device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }
    if cfg.method == RangeMethod.cross_entropy:
        # the cross-entropy is over the last (class) axis of logits
        if per_channel:
            raise ValueError("cross_entropy estimation is per-tensor only")
        return {
            "search_grid": torch.zeros((cfg.num_candidates, 1), device=device),
            "losses": torch.zeros((cfg.num_candidates, 1), device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device),
        }
    raise ValueError(f"unknown range estimator {cfg.method}")


def uses_search_grid(cfg: EstimatorConfig) -> bool:
    """Whether the estimator adopts a candidate grid from its first batch."""
    return cfg.method in (RangeMethod.MSE, RangeMethod.cross_entropy)


def update(cfg: EstimatorConfig, qcfg: QuantizerConfig, state: EstState, x,
           per_channel: bool, channel_axis: int = 0) -> Tuple[EstState, Ranges]:
    """Fold one batch into the state; return updated state + current ranges."""
    if cfg.method == RangeMethod.MSE:
        return _fp_mse(cfg, qcfg, state, x, per_channel, channel_axis)
    if cfg.method == RangeMethod.cross_entropy:
        return _cross_entropy(cfg, qcfg, state, x)
    xf = _channelize(x, per_channel, channel_axis)
    if cfg.method == RangeMethod.current_minmax and cfg.percentile:
        x_min, x_max = _percentiles(xf, cfg.percentile)
        return {"xmin": x_min, "xmax": x_max, "count": state["count"] + 1}, (x_min, x_max, None)
    x_min = xf.amin(dim=-1)
    x_max = xf.amax(dim=-1)
    if cfg.method == RangeMethod.allminmax:
        x_min = torch.minimum(state["xmin"], x_min)
        x_max = torch.maximum(state["xmax"], x_max)
    elif cfg.method == RangeMethod.running_minmax:
        # an exponential moving average with weight ``momentum`` on the
        # state, taken from the first batch as it is
        first, m = state["count"] == 0, cfg.momentum
        x_min = torch.where(first, x_min, (1 - m) * x_min + m * state["xmin"])
        x_max = torch.where(first, x_max, (1 - m) * x_max + m * state["xmax"])
    new = {"xmin": x_min, "xmax": x_max, "count": state["count"] + 1}
    return new, (x_min, x_max, None)


def _percentiles(xf, percentile: float):
    """The ``percentile`` and ``100 - percentile`` points of each row of
    ``xf``, interpolated linearly between order statistics as
    ``jnp.percentile`` does (a NaN row gives NaN). A sort and two gathers:
    ``torch.quantile`` refuses inputs above 2^24 elements."""
    n = xf.shape[-1]
    q = torch.tensor([percentile, 100.0 - percentile], dtype=torch.float32,
                     device=xf.device) / 100
    pos = q * float(n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    low = low.clamp(0, n - 1).long()
    high = high.clamp(0, n - 1).long()
    v = torch.sort(xf, dim=-1).values
    v = torch.where(torch.isnan(xf).any(dim=-1, keepdim=True), torch.nan, v)
    # low * lw + high * hw with one rounding after the first product, as
    # XLA's CPU backend fuses it (exact in f64 before the cast)
    out = (v[:, low].double() * lw.double() + (v[:, high] * hw).double()).to(torch.float32)
    return out[:, 0], out[:, 1]


def _fp_mse(cfg, qcfg, state, x, per_channel, channel_axis):
    """The FP8 (mantissa_bits, maxval) grid search. The candidate grid, 111
    points in [0.1 mx, 1.2 mx] per channel, is adopted from the first batch
    (``count == 0``); each batch adds its per-candidate mean squared errors
    (over the non-channel axes) to the state; the mantissa width is elected
    by per-channel plurality (the smallest width wins a tie), then each
    channel takes its best ``maxval`` at that width."""
    mbit_list = _mbit_list(qcfg)
    x = x.to(torch.float32)
    xf = _channelize(x, per_channel, channel_axis)          # (C, N)
    c = xf.shape[0]

    mxs = torch.maximum(xf.amin(dim=-1).abs(), xf.amax(dim=-1).abs())
    fresh = _search_linspace(0.1 * mxs, 1.2 * mxs, cfg.num_candidates)   # (ncand, C)
    grid = torch.where(state["count"] == 0, fresh, state["search_grid"])

    if qcfg.fp8.allow_unsigned:
        sign_bits = torch.any(x < 0).to(torch.int32)
    else:
        sign_bits = torch.ones((), dtype=torch.int32, device=x.device)

    mses = state["mses"] + _candidate_mses(xf, grid, mbit_list, qcfg.n_bits, sign_bits)

    # elect the mantissa width by per-channel plurality vote
    best_per_channel = torch.argmin(mses.amin(dim=1), dim=0)          # (C,)
    votes = torch.bincount(best_per_channel, minlength=len(mbit_list))
    best_idx = torch.argmax(votes)                                     # first of a tie
    best_mbits = torch.tensor(mbit_list, device=x.device)[best_idx]

    # each channel's best maxval at the elected width
    cand_idx = torch.argmin(mses[best_idx], dim=0)                    # (C,)
    maxval = grid[cand_idx, torch.arange(c, device=x.device)]

    new = {"search_grid": grid, "mses": mses, "count": state["count"] + 1}
    sign_f = sign_bits.to(torch.float32)
    return new, (-sign_f * maxval, maxval, best_mbits.reshape(1))


def _candidate_mses(xf, grid, mbit_list, n_bits: int, sign_bits):
    """(n_mbits, ncand, C): the mean squared error of each row of ``xf``
    quantized on each candidate ``maxval`` of its column of ``grid`` at each
    width of ``mbit_list``."""
    c, n = xf.shape
    step = _chunk(c * n)
    out = [[] for _ in mbit_list]
    with torch.no_grad():
        for s in range(0, grid.shape[0], step):
            for i, q in enumerate(quantize_to_fp8_widths(xf[None], n_bits,
                                                         grid[s:s + step, :, None],
                                                         mbit_list, sign_bits)):
                q.sub_(xf)
                out[i].append(q.mul_(q).mean(dim=-1))
    return torch.stack([torch.cat(o) for o in out])


def _batched_apply(qcfg: QuantizerConfig, x, neg, pos):
    """``x`` quantized on each candidate range ``[neg_i, pos_i]`` (the
    default ``apply_fn`` of the searches): a per-tensor quantizer whose
    ranges are set from scalars, for K candidates at once as one
    per-channel state over a leading candidate axis, (K, *x.shape)."""
    from . import quantizers

    k = pos.shape[0]
    cfg = dataclasses.replace(qcfg, per_channel=True)
    st = quantizers.set_quant_range(cfg, quantizers.init(cfg, k, x.device), neg, pos)
    return quantizers.apply(cfg, st, x.expand(k, *x.shape), channel_axis=0)


def _cross_entropy(cfg, qcfg, state, x):
    """The threshold line search for logits quantizers: ``num_candidates``
    symmetric clipping thresholds up to ``max|x| + range_margin`` (adopted
    from the first batch), each scored by ``H(softmax(x), log_softmax(x_q))``
    over the last axis, the scores summed over batches."""
    x = x.to(torch.float32)
    x2d = x.reshape(-1, x.shape[-1])
    p = torch.softmax(x2d, dim=-1)

    mx = torch.maximum(x.amin().abs(), x.amax().abs()) + cfg.range_margin
    # ``arange(1, n + 1) / n * mx`` as XLA compiles it: i * (mx * f32(1 / n))
    recip = torch.tensor(1.0 / cfg.num_candidates, dtype=torch.float32, device=x.device)
    fresh = (torch.arange(1, cfg.num_candidates + 1, dtype=torch.float32, device=x.device)
             * (mx * recip)).reshape(-1, 1)
    grid = torch.where(state["count"] == 0, fresh, state["search_grid"])

    pos = grid[:, 0]
    step = _chunk(x2d.numel())
    ces = []
    for s in range(0, pos.shape[0], step):
        pc = pos[s:s + step]
        logq = torch.log_softmax(_batched_apply(qcfg, x2d, -pc, pc), dim=-1)
        ces.append(-(p * logq).sum(dim=(1, 2)))
    losses = state["losses"] + torch.cat(ces).reshape(-1, 1)
    x_max = grid[torch.argmin(losses[:, 0])]
    new = {"search_grid": grid, "losses": losses, "count": state["count"] + 1}
    return new, (-x_max, x_max, None)


def line_search_ranges(x, qcfg: QuantizerConfig, num_candidates: int = 1000,
                       range_margin: float = 0.5, apply_fn=None, opt_method=None):
    """1-D symmetric line search for clipping thresholds (the analytic error
    tools' estimator): sweep ``num_candidates`` thresholds up to ``max|x| +
    range_margin``, quantize with each and take the one of least summed
    squared error; one-sided when the data is non-negative.

    ``opt_method`` (``config.OptMethod`` or its value) selects the grid
    (default) or a 40-step golden-section bracket shrink on the threshold.
    ``apply_fn(x, x_min, x_max) -> x_q`` overrides the quantizer, called
    once a candidate. Returns (x_min, x_max) scalars."""
    if opt_method is None:
        opt_method = OptMethod.grid
    opt_method = OptMethod(opt_method)

    x = torch.as_tensor(x).to(torch.float32)
    one_sided = torch.all(x >= 0)
    max_pos_thr = torch.maximum(x.amin().abs(), x.amax()) + range_margin
    step = max_pos_thr / num_candidates

    def losses_for(pos):
        """(K,) summed squared errors of the K thresholds ``pos``."""
        neg = torch.where(one_sided, 0.0, -pos)
        if apply_fn is None:
            y = _batched_apply(qcfg, x, neg, pos)
        else:
            y = torch.stack([apply_fn(x, neg[i], pos[i]) for i in range(pos.shape[0])])
        return ((x - y) ** 2).reshape(pos.shape[0], -1).sum(dim=-1)

    if opt_method == OptMethod.golden_section:
        invphi = (5.0 ** 0.5 - 1.0) / 2.0
        a, b = step, max_pos_thr
        for _ in range(40):
            c = b - invphi * (b - a)
            d = a + invphi * (b - a)
            lc, ld = losses_for(torch.stack([c, d]))
            shrink_right = lc < ld
            a, b = torch.where(shrink_right, a, c), torch.where(shrink_right, d, b)
        x_max = (a + b) / 2.0
    else:
        idxs = torch.arange(1, num_candidates + 1, dtype=torch.float32, device=x.device)
        chunk = _chunk(x.numel())
        losses = torch.cat([losses_for(step * idxs[s:s + chunk])
                            for s in range(0, num_candidates, chunk)])
        x_max = step * idxs[torch.argmin(losses)]
    x_min = torch.where(one_sided, 0.0, -x_max)
    return x_min, x_max
