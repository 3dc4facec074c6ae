"""Eval driver: calibrate -> fix -> evaluate (port of ``eval/driver.py``).

The JAX package threads the ``quant`` / ``quant_est`` collections through
jitted steps; here the QuantSites update their buffers in place during the
``ESTIMATE`` forwards, and ``FIXED`` forwards read them frozen.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from .. import LATER as _LATER
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
def evaluate(model, batches: Iterable[Batch], *, quant_w: bool = True,
             quant_a: bool = True, fast: bool = False, packed: bool = False,
             chained: bool = False, topk: int = 5) -> Dict[str, float]:
    """``FIXED``-phase eval loop with accumulator metrics."""
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
    bn_reestimate_batches: Optional[Iterable[Any]] = None,
) -> Tuple[Dict[str, float], Any]:
    """The validate-quantized pipeline. Returns (final_metrics, calibrated
    model)."""
    if bn_reestimate_batches is not None:
        raise NotImplementedError(f"BN re-estimation {_LATER}")
    if packed or chained or fast:
        raise NotImplementedError(f"fast / packed / chained evaluation {_LATER}")
    calibrate(model, calib_batches, num_est_batches=num_est_batches,
              quant_w=quant_w, quant_a=quant_a)
    metrics = evaluate(model, eval_batches, quant_w=quant_w, quant_a=quant_a)
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
