"""Model inspection: per-tensor weight summaries, the quantizer state and
weight histograms (port of ``analysis/inspect.py``).

~ reference ``hooks/hook_demo.py:134-202`` (module traversal + matplotlib
weight histograms). Works on a ``state_dict``, on ``named_parameters()``
pairs or on a module (its ``state_dict``); names are the dotted ``state_dict``
keys where the JAX package has ``/``-joined variable paths. Plotting is
optional (matplotlib may be absent); the numeric summaries always work.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..quant import quantizers

Tensors = Union[nn.Module, Mapping, Iterable[Tuple[str, torch.Tensor]]]


def _named(tensors: Tensors):
    if isinstance(tensors, nn.Module):
        tensors = tensors.state_dict()
    return tensors.items() if isinstance(tensors, Mapping) else tensors


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def weight_summaries(params: Tensors) -> List[Dict]:
    """Per-tensor summary stats of every tensor with at least one dim."""
    rows = []
    for name, leaf in _named(params):
        arr = _numpy(leaf)
        if arr.ndim == 0:
            continue
        rows.append({
            "name": name,
            "shape": tuple(arr.shape),
            "min": float(arr.min()),
            "max": float(arr.max()),
            "mean": float(arr.mean()),
            "std": float(arr.std()),
            "abs_max": float(np.abs(arr).max()),
        })
    return rows


def _quantizer_keys() -> frozenset:
    """The state keys a QuantSite's quantizer holds, for any method (the
    JAX ``quant`` collection's leaves)."""
    from ..config import QMethod, QuantizerConfig

    return frozenset(k for method in QMethod
                     for k in quantizers.init(QuantizerConfig(method=method)))


def quant_state_summary(state: Tensors) -> List[Dict]:
    """Per-site quantizer parameters (maxval ranges, elected mantissa bits):
    what the JAX package's ``quant`` collection holds. A site keeps its
    estimator's state beside them (JAX's ``quant_est``), which is left out:
    the entries kept are those named as a quantizer's state keys."""
    keys = _quantizer_keys()
    rows = []
    for name, leaf in _named(state):
        if name.rpartition(".")[2] not in keys:
            continue
        arr = _numpy(leaf)
        rows.append({
            "name": name,
            "shape": tuple(arr.shape),
            "min": float(arr.min()) if arr.size else None,
            "max": float(arr.max()) if arr.size else None,
        })
    return rows


def weight_histograms(
    params: Tensors,
    out_dir: str,
    bins: int = 101,
    select: Optional[str] = None,
) -> List[Tuple[str, str]]:
    """Write per-tensor weight histogram PNGs (hook_demo.py analog).

    Returns (tensor_name, file_path) pairs; returns [] if matplotlib is
    unavailable.
    """
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return []

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, leaf in _named(params):
        if select and select not in name:
            continue
        arr = _numpy(leaf)
        if arr.size < 2:
            continue
        fig, ax = plt.subplots(figsize=(6, 3))
        ax.hist(arr.ravel(), bins=bins)
        ax.set_title(f"{name}  {tuple(arr.shape)}")
        fname = os.path.join(out_dir, name.replace(".", "_") + ".png")
        fig.savefig(fname, dpi=80, bbox_inches="tight")
        plt.close(fig)
        written.append((name, fname))
    return written
