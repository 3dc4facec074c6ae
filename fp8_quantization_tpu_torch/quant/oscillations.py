"""Oscillation dampening and freezing for low-bit QAT (port of
``quant/oscillations.py``; Nagel et al., "Overcoming Oscillations in
Quantization-Aware Training", ICML 2022).

* **Dampening** (``--oscillations-dampen-*``): a regularizer
  ``sum((sg(quantize(w)) - w)^2)`` added to the loss. The quantized value
  is a constant (``detach``), so the gradient ``2 * (w - w_q)`` pulls each
  latent weight toward the center of its quantization bin. Aggregations:
  ``sum`` | ``mean`` (global) | ``kernel_mean`` (per-kernel mean, summed).
  The weight anneals with a cosine from ``weight`` to ``weight_final``
  from ``anneal_start`` of training on.
* **Freezing** (``--oscillations-freeze-*``): each weight's oscillation
  frequency is an EMA of flip events (an integer-code change whose
  direction reverses the previous change): ``freq = m * osc + (1 - m) *
  freq``. When it exceeds the (annealed) threshold the weight freezes: its
  code is pinned (to the rounded EMA of past codes under ``use_ema``, else
  to the code at freeze time), the latent weight is projected onto that
  code's value after each step, and its optimizer updates are undone. Only
  uniform weight quantizers of at most ``max_bits`` bits are tracked.

The JAX package threads a pytree through its jitted step; here the
functions read the model's layers (each ``kernel`` with its
``weight_quantizer`` site) and the tracker state is a dict keyed by the
layer path as the JAX package writes it (``features_1/conv_0``). ``round``
is half to even in both frameworks and ``w / scale`` is one IEEE division,
so the freezing functions equal the JAX package's bit for bit on equal
inputs.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import torch

from ..config import OscDampConfig, OscFreezeConfig, QMethod, QuantizerConfig
from . import quantizers
from .sites import QuantSite

FreezeState = Dict[str, Dict[str, torch.Tensor]]


def cosine_anneal(step, total_steps: int, start: float, final: Optional[float],
                  rel_start: float) -> torch.Tensor:
    """Constant ``start`` before ``rel_start * total_steps``, then a cosine
    decay to ``final``; ``final=None`` means no annealing. In f32, as the
    JAX package computes it inside its step."""
    if final is None:
        return torch.tensor(start, dtype=torch.float32)
    t0 = rel_start * total_steps
    rel = torch.clamp((torch.tensor(step, dtype=torch.float32) - t0)
                      / max(total_steps - t0, 1e-9), 0.0, 1.0)
    return final + 0.5 * (start - final) * (1.0 + torch.cos(rel * math.pi))


def iter_weight_sites(model: torch.nn.Module
                      ) -> Iterator[Tuple[str, torch.Tensor, Dict[str, torch.Tensor]]]:
    """Yield ``(path, kernel, weight-quantizer state)`` for each quantized
    kernel, ``path`` the layer's module path with ``/`` between levels."""
    for name, m in model.named_modules():
        kernel = getattr(m, "kernel", None)
        site = getattr(m, "weight_quantizer", None)
        if isinstance(kernel, torch.Tensor) and isinstance(site, QuantSite):
            yield name.replace(".", "/"), kernel, site.quant_state()


def dampening_loss(model: torch.nn.Module, wq_cfg: QuantizerConfig,
                   aggregation: str = "kernel_mean", channel_axis: int = -1):
    """Bin-center regularizer over every quantized kernel. ``w_q`` is
    detached: the STE would make ``d(w_q)/dw = 1`` and the gradient zero."""
    total = 0.0
    count = 0
    for _path, w, q in iter_weight_sites(model):
        w_q = quantizers.apply(wq_cfg, q, w, channel_axis=channel_axis).detach()
        err = (w_q - w.to(torch.float32)) ** 2
        if aggregation == "kernel_mean":
            total = total + err.mean()
        else:
            total = total + err.sum()
            count += err.numel()
    if aggregation == "mean" and count:
        total = total / count
    return torch.as_tensor(total, dtype=torch.float32)


def dampening_weight(cfg: OscDampConfig, step, total_steps: int) -> torch.Tensor:
    """Annealed regularizer weight for the current step."""
    return cosine_anneal(step, total_steps, cfg.weight, cfg.weight_final, cfg.anneal_start)


def _int_coords(wq_cfg: QuantizerConfig, q: dict, w, channel_axis: int = -1):
    """(x_int, scale, zero_point) of ``w`` on its frozen uniform grid: the
    integer-domain view of ``quantizers.uniform_apply``."""
    delta = quantizers.bcast_param(q["delta"], w.ndim, channel_axis)
    scale = quantizers.uniform_scale(wq_cfg, delta)
    if wq_cfg.method == QMethod.symmetric_uniform:
        int_min, int_max = quantizers.sym_int_bounds(wq_cfg, q["signed"])
        zero_point = 0.0
    else:
        int_min, int_max = 0.0, 2.0 ** wq_cfg.n_bits - 1
        zp = torch.round(quantizers.bcast_param(q["zero_float"], w.ndim, channel_axis))
        zero_point = torch.clamp(zp, int_min, int_max)
    x_int = torch.clamp(torch.round(w / scale) + zero_point, int_min, int_max)
    return x_int, scale, zero_point


def _tracked(cfg: OscFreezeConfig, wq_cfg: QuantizerConfig) -> bool:
    return (cfg.threshold > 0.0 and wq_cfg.method != QMethod.fp_quantizer
            and wq_cfg.n_bits <= cfg.max_bits)


@torch.no_grad()
def freeze_init(cfg: OscFreezeConfig, wq_cfg: QuantizerConfig,
                model: torch.nn.Module) -> FreezeState:
    """Per-weight tracker state; empty when freezing does not apply."""
    state: FreezeState = {}
    if not _tracked(cfg, wq_cfg):
        return state
    for path, w, q in iter_weight_sites(model):
        x_int, _, _ = _int_coords(wq_cfg, q, w)
        state[path] = {
            "prev_int": x_int,
            "prev_dir": torch.zeros_like(x_int),
            "freq": torch.zeros_like(x_int),
            "int_ema": x_int,
            "frozen": torch.zeros(x_int.shape, dtype=torch.bool, device=x_int.device),
            "target_int": x_int,
        }
    return state


@torch.no_grad()
def freeze_update(cfg: OscFreezeConfig, wq_cfg: QuantizerConfig, state: FreezeState,
                  model: torch.nn.Module, threshold) -> FreezeState:
    """One tracking step after the optimizer update: detect direction-
    reversing code flips, update the frequency EMA, and freeze the weights
    whose frequency crosses ``threshold``."""
    m = cfg.ema_momentum
    new_state: FreezeState = {}
    sites = {p: (w, q) for p, w, q in iter_weight_sites(model)}
    for key, s in state.items():
        w, q = sites[key]
        x_int, _, _ = _int_coords(wq_cfg, q, w)
        changed = x_int != s["prev_int"]
        direction = torch.sign(x_int - s["prev_int"])
        osc = changed & (direction == -s["prev_dir"]) & (s["prev_dir"] != 0)
        freq = m * osc.to(torch.float32) + (1.0 - m) * s["freq"]
        int_ema = m * x_int + (1.0 - m) * s["int_ema"]
        newly = (freq > threshold) & ~s["frozen"]
        pin = torch.round(int_ema) if cfg.use_ema else x_int
        new_state[key] = {
            "prev_int": x_int,
            "prev_dir": torch.where(changed, direction, s["prev_dir"]),
            "freq": freq,
            "int_ema": int_ema,
            "frozen": s["frozen"] | newly,
            "target_int": torch.where(newly, pin, s["target_int"]),
        }
    return new_state


def freeze_threshold(cfg: OscFreezeConfig, step, total_steps: int) -> torch.Tensor:
    return cosine_anneal(step, total_steps, cfg.threshold, cfg.threshold_final,
                         cfg.anneal_start)


@torch.no_grad()
def project_frozen(wq_cfg: QuantizerConfig, state: FreezeState, model: torch.nn.Module):
    """Pin the latent weights of frozen entries onto their target code's
    value, so the forward quantizer reproduces the frozen code exactly.
    Writes the kernels in place; returns the model."""
    if not state:
        return model
    sites = {p: (w, q) for p, w, q in iter_weight_sites(model)}
    for key, s in state.items():
        w, q = sites[key]
        _, scale, zero_point = _int_coords(wq_cfg, q, w)
        pinned = scale * (s["target_int"] - zero_point)
        w.copy_(torch.where(s["frozen"], pinned, w))
    return model


@torch.no_grad()
def kernels(model: torch.nn.Module, state: FreezeState) -> Dict[str, torch.Tensor]:
    """Copies of the tracked kernels, by path (their values before a step)."""
    if not state:
        return {}
    return {p: w.detach().clone() for p, w, _ in iter_weight_sites(model) if p in state}


@torch.no_grad()
def mask_frozen_updates(state: FreezeState, model: torch.nn.Module,
                        before: Dict[str, torch.Tensor]):
    """Undo the optimizer's update of frozen weights: their kernels go back
    to ``before`` (``kernels`` taken ahead of the step), which is the JAX
    package's zeroed update ``w + 0``. Returns the model."""
    if not state:
        return model
    for path, w, _ in iter_weight_sites(model):
        if path in state:
            w.copy_(torch.where(state[path]["frozen"], before[path], w))
    return model


def frozen_fraction(state: FreezeState) -> torch.Tensor:
    """Diagnostic: the fraction of tracked weights currently frozen."""
    if not state:
        return torch.tensor(0.0)
    tot = sum(s["frozen"].numel() for s in state.values())
    frz = sum(s["frozen"].sum() for s in state.values())
    return frz / tot
