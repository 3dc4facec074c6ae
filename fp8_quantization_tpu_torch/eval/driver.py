"""Eval driver: calibrate -> fix -> evaluate (port of ``eval/driver.py``).

The JAX package threads the ``quant`` / ``quant_est`` collections through
jitted steps; here the QuantSites update their buffers in place during the
``ESTIMATE`` forwards, and ``FIXED`` forwards read them frozen; BN
re-estimation writes each BN layer's running stats in place. The serving
phases (``fast``, ``packed``, ``chained``) first cache the frozen weights
(``cache_quantized_weights``) and pack them to 1-byte codes
(``ops.fastpath.pack_dense_caches``), in place on the model.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from ..quant.sites import QuantPhase
from .metrics import MetricState, finalize_metrics, update_metrics

Batch = Tuple[Any, Any]


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _as_input(x, device):
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


@torch.no_grad()
def calibrate(model, batches: Iterable[Any], *, num_est_batches: Optional[int] = None,
              quant_w: bool = True, quant_a: bool = True):
    """Range-estimation pass: ``ESTIMATE`` forwards over at most
    ``num_est_batches`` batches (inputs, or (input, label) pairs). Updates
    the model's site state in place and returns the model."""
    qp = QuantPhase(phase="estimate", quant_w=quant_w, quant_a=quant_a)
    dev = _device(model)
    for i, batch in enumerate(batches):
        if num_est_batches is not None and i >= num_est_batches:
            break
        x = batch[0] if isinstance(batch, tuple) else batch
        model(_as_input(x, dev), qp)
    return model


@torch.no_grad()
def reestimate_bn(model, batches: Iterable[Any], *, num_batches: int = 50,
                  quant_w: bool = True, quant_a: bool = True):
    """BN re-estimation: at most ``num_batches`` fixed-phase forwards in
    which every BN layer normalizes with its batch's stats, then each
    layer's running mean and variance become the average of its per-batch
    stats. A model without BN is left as it is. Returns the model."""
    bns = [m for m in model.modules() if getattr(m, "bn_follows", False)]
    if not bns:
        return model
    qp = QuantPhase(phase="fixed", quant_w=quant_w, quant_a=quant_a, reestimate_bn=True)
    dev = _device(model)
    total, count = None, 0
    for i, batch in enumerate(batches):
        if i >= num_batches:
            break
        x = batch[0] if isinstance(batch, tuple) else batch
        model(_as_input(x, dev), qp)
        stats = [(m.mean.clone(), m.var.clone()) for m in bns]
        total = stats if total is None else [
            (tm + sm, tv + sv) for (tm, tv), (sm, sv) in zip(total, stats)]
        count += 1
    for m, (mean, var) in zip(bns, total or []):
        m.mean.copy_(mean / count)
        m.var.copy_(var / count)
    return model


@torch.no_grad()
def cache_quantized_weights(model, example, *, quant_a: bool = True,
                            fast: bool = False):
    """Store the frozen quantized weights in each layer's cache (one
    forward of ``example``); fixed-phase forwards then skip the weight
    quantization. ``fast=True`` stores them bfloat16 (lossless for the
    grid) for the fast serving modes. Returns the model."""
    qp = QuantPhase(phase="fixed", quant_a=quant_a, cache_weights=True, fast=fast)
    model(_as_input(example, _device(model)), qp)
    return model


@torch.no_grad()
def evaluate(model, batches: Iterable[Batch], *, quant_w: bool = True,
             quant_a: bool = True, fast: bool = False, packed: bool = False,
             chained: bool = False, topk: int = 5) -> Dict[str, float]:
    """``FIXED``-phase eval loop with accumulator metrics. ``fast``,
    ``packed`` and ``chained`` select the serving phase (see
    ``quant.sites.QuantPhase``); ``packed`` needs the packed codes of
    :func:`validate_quantized`."""
    qp = QuantPhase(phase="fixed", quant_w=quant_w, quant_a=quant_a, fast=fast,
                    packed=packed, chained=chained)
    dev = _device(model)
    state = MetricState.zero(dev)
    for x, y in batches:
        logits = model(_as_input(x, dev), qp)
        state = update_metrics(state, logits, torch.as_tensor(y).to(dev), k=topk)
    return finalize_metrics(state)


def validate_quantized(
    model,
    calib_batches: Iterable[Any],
    eval_batches: Iterable[Batch],
    *,
    num_est_batches: int = 1,
    quant_w: bool = True,
    quant_a: bool = True,
    fast: bool = False,
    packed: bool = False,
    chained: bool = False,
    qc=None,
    calib_example=None,
    bn_reestimate_batches: Optional[Iterable[Any]] = None,
) -> Tuple[Dict[str, float], Any]:
    """The validate-quantized pipeline. ``bn_reestimate_batches`` re-estimates
    the BN stats after calibration (:func:`reestimate_bn`). ``packed=True``
    (needs ``qc`` and ``calib_example``) freezes the quantized weights and
    installs 1-byte codes before evaluating under the packed phase. Returns
    (final_metrics, calibrated model)."""
    calibrate(model, calib_batches, num_est_batches=num_est_batches,
              quant_w=quant_w, quant_a=quant_a)
    if bn_reestimate_batches is not None:
        reestimate_bn(model, bn_reestimate_batches, quant_w=quant_w, quant_a=quant_a)
    if packed:
        if qc is None or calib_example is None:
            raise ValueError("packed eval needs qc and calib_example")
        from ..ops.fastpath import pack_dense_caches

        cache_quantized_weights(model, calib_example, quant_a=quant_a, fast=fast)
        pack_dense_caches(model, qc)
    metrics = evaluate(model, eval_batches, quant_w=quant_w, quant_a=quant_a,
                       fast=fast, packed=packed, chained=chained)
    return metrics, model


def write_result_file(output_dir: str, arch: str, approx_cfg, run_method_cfg,
                      metrics: Dict[str, float]) -> str:
    """Run-result file, the reference's naming scheme:
    ``<out>/<arch>/E{e}M{m}D{d}/D{d}_<timestamp>.txt``."""
    e, m, d = approx_cfg.expo_width, approx_cfg.mant_width, approx_cfg.dnsmp_factor
    subdir = os.path.join(output_dir, arch, f"E{e}M{m}D{d}")
    os.makedirs(subdir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    path = os.path.join(subdir, f"D{d}_{stamp}.txt")
    with open(path, "w") as f:
        f.write(f"run_method: {dataclasses.asdict(run_method_cfg)}\n")
        f.write(f"approx_params: {dataclasses.asdict(approx_cfg)}\n")
        f.write(f"final_metrics: {json.dumps(metrics)}\n")
    return path
