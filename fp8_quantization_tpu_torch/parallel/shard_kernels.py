"""Tensor-parallel partitioning of the packed and int4 kernels, port of
``parallel/shard_kernels.py``.

The JAX package wraps K4 (``dequant_matmul``) and K5 (``int4_matmul``) in
``jax.shard_map`` over a mesh, so that each chip decodes only its
``(K, N/model)`` code shard and its rows of ``x``; GSPMD would otherwise
gather the byte codes and run the kernel whole on every chip. The port does
the same by hand: inside :func:`partitioned_kernels` the packed dense paths
of ``ops.layers`` launch the kernel once per ``(d, m)`` cell, on the cell's
device, on the rows of ``x`` for ``d`` and the contiguous code and bias
shards for ``m`` that ``sharding.shard_variables`` placed, and gather the
``(M, N)`` result on the mesh's first device. The byte codes are never
concatenated.

When N does not divide over ``model`` (or no context is active) the call
is the unsharded one. When M does not divide over ``data`` the rows are
not split: JAX then replicates ``x`` and computes the same ``(M, N/model)``
block on every data cell, which the port computes once, on the cells of
data index 0. ``CALLS`` counts partitioned calls, unsharded calls made
inside a context, and weights split at the call because they had no live
placement on the mesh (the counterpart of XLA's involuntary
rematerialization): the last two are the silent fallbacks a caller can
assert away.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

from . import sharding
from .sharding import Mesh

_KERNEL_MESH: contextvars.ContextVar[Optional[Tuple[Mesh, str, str]]] = (
    contextvars.ContextVar("kernel_mesh", default=None))

# partitioned calls; unsharded calls inside a context; weight tensors split
# at a call for want of a placement on the active mesh
CALLS = {"partitioned": 0, "unsharded": 0, "split_on_call": 0}


def reset_calls():
    for key in CALLS:
        CALLS[key] = 0


@contextlib.contextmanager
def partitioned_kernels(mesh: Mesh, data_axis: str = "data", model_axis: str = "model"):
    """Partition packed-kernel calls made inside this context over ``mesh``:
    weight codes shard their output-channel (N) axis over ``model_axis``,
    activations shard their row (batch * token) axis over ``data_axis``."""
    token = _KERNEL_MESH.set((mesh, data_axis, model_axis))
    try:
        yield
    finally:
        _KERNEL_MESH.reset(token)


def kernel_mesh() -> Optional[Tuple[Mesh, str, str]]:
    """The active (mesh, data_axis, model_axis), or None."""
    return _KERNEL_MESH.get()


def _plan(m: int, n: int):
    """Resolve the active context to (mesh, data axis or None, model axis)
    when the shapes divide the mesh axes; None -> the unsharded call."""
    ctx = _KERNEL_MESH.get()
    if ctx is None:
        return None
    mesh, dax, max_ = ctx
    msize = mesh.shape.get(max_, 1)
    dsize = mesh.shape.get(dax, 1)
    if msize <= 1:
        return None
    if n % msize != 0:
        return None  # the channel axis does not divide: replicate
    d = dax if (dsize > 1 and m % dsize == 0) else None
    return mesh, d, max_


def _unsharded():
    if _KERNEL_MESH.get() is not None:
        CALLS["unsharded"] += 1


def _column_shards(t: torch.Tensor, mesh: Mesh, model_axis: str):
    """``t``'s shards with its last axis over ``model_axis``: the live
    placement where there is one, else split now (and counted)."""
    spec = (None,) * (t.ndim - 1) + (model_axis,)
    sh = sharding.shards_of(t, mesh)
    if sh is not None and sh.spec == spec:
        return sh.grid
    CALLS["split_on_call"] += 1
    with torch.no_grad():
        return sharding.split(t, mesh, spec)


def _partitioned(kernel, x2d, w, extras, plan, **kw):
    """Launch ``kernel(x_rows, w_shard, *extra_shards, **kw)`` on every
    cell of the plan and gather the (M, N) result on the first device.
    ``extras``: (tensor, per_column) pairs; a per-column tensor takes its
    column shard, any other is replicated."""
    mesh, dax, max_ = plan
    CALLS["partitioned"] += 1
    w_grid = _column_shards(w, mesh, max_)
    e_grids = [_column_shards(e, mesh, max_) if per_column else None for e, per_column in extras]
    rows_split = mesh.shape[dax] if dax is not None else 1
    models = mesh.shape[max_]
    m_rows, n = x2d.shape[0], w.shape[-1]
    rs, cs = m_rows // rows_split, n // models
    out = None
    for d in range(rows_split):
        for j in range(models):
            dev = mesh.devices[d, j]
            xs = x2d[d * rs:(d + 1) * rs].to(dev)
            args = [e_grid[d][j] if e_grid is not None else e.to(dev)
                    for (e, _), e_grid in zip(extras, e_grids)]
            part = kernel(xs, w_grid[d][j], *args, **{k: (v.to(dev) if isinstance(
                v, torch.Tensor) else v) for k, v in kw.items()})
            if out is None:
                out = torch.empty((m_rows, n), dtype=part.dtype, device=mesh.first)
            out[d * rs:(d + 1) * rs, j * cs:(j + 1) * cs].copy_(part)
    return out


def sharded_dequant_matmul(x2d, codes, bias, **kwargs):
    """``ops.cuda.dequant_matmul.dequant_matmul`` (K4) with the N axis
    tensor-parallel.

    x2d: (M, K) bf16/f32, or uint8 chained codes (the per-tensor ``x_bias``
    in ``kwargs`` is replicated); codes: (K, N) uint8; bias: (N,) int32
    (a one-entry bias is replicated). Each cell decodes and multiplies only
    its (K, N/model) shard."""
    from ..ops.cuda import dequant_matmul as k4

    plan = _plan(x2d.shape[0], codes.shape[1])
    if plan is None:
        _unsharded()
        return k4.dequant_matmul(x2d, codes, bias, **kwargs)
    per_column = bias.ndim == 1 and bias.shape[0] == codes.shape[1]
    return _partitioned(k4.dequant_matmul, x2d, codes, [(bias, per_column)], plan, **kwargs)


def sharded_int4_matmul(x_codes, w4, *, k: int):
    """``ops.cuda.dequant_matmul.int4_matmul`` (K5) with the N axis
    tensor-parallel: each cell unpacks and multiplies its (ceil(K/2),
    N/model) nibble shard. The int32 sums come back whole on the first
    device, where the zero-point and scale epilogue
    (``fastpath.quantized_matmul_int8``) runs."""
    from ..ops.cuda import dequant_matmul as k4

    plan = _plan(x_codes.shape[0], w4.shape[1])
    if plan is None:
        _unsharded()
        return k4.int4_matmul(x_codes, w4, k=k)
    return _partitioned(k4.int4_matmul, x_codes, w4, [], plan, k=k)
