"""Mesh and placement rules, port of ``parallel/sharding.py``.

The JAX package is single-controller: one process drives every chip of a
``jax.sharding.Mesh``, places each variable by a ``NamedSharding`` and lets
GSPMD partition the program, including the global min/max reductions of
calibration and the sums of the eval metrics. The port keeps one process
too. A :class:`Mesh` is a ``(data, model)`` grid of ``torch.device``s, and
placing a tensor on it stores one contiguous shard per grid cell on that
cell's device. A mesh may repeat a device (a virtual mesh: eight times the
CPU in the tests, eight times ``cuda:0`` on one card); a shard is then
stored once per distinct device, not once per cell.

What runs per shard is what the JAX package partitions by hand: the K4/K5
products (``shard_kernels``) and ring attention (``ring_attention``). The
rest of a step runs on the mesh's first device, on the whole tensors, as
GSPMD's result is the whole tensor; that is where the model and its cache
live. So :func:`shard_variables` places only the tensors the partitioned
products read per shard (``PARTITIONED``: the packed FP8 codes, their
per-column packing bias and the int4 nibble codes); every other parameter
stays whole on its own device. A placement is kept on the tensor object
itself and lapses when the tensor is written in place afterwards (its
version moves on).

Rules, as in the JAX package:
* weights and per-channel quant params shard their channel (last) axis over
  ``model`` when it divides;
* batches shard their leading axis over ``data``;
* scalars and small states replicate.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

# the buffers the partitioned K4/K5 products read per shard: packed FP8
# weight codes, their per-column packing bias, int4 nibble codes
PARTITIONED = ("w_codes", "w_pack_bias", "w_i4")


class Mesh:
    """A ``(data, model)`` grid of devices: ``devices[d, m]`` is cell
    ``(d, m)``'s ``torch.device``. ``shape`` maps each axis to its size,
    as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a (data, model) grid, got shape {devices.shape}")
        self.devices = devices
        self.shape = {"data": devices.shape[0], "model": devices.shape[1]}
        self.key = (devices.shape, tuple(str(d) for d in devices.flat))

    @property
    def first(self) -> torch.device:
        """The device where the unpartitioned part of a step runs."""
        return self.devices[0, 0]

    @property
    def size(self) -> int:
        return self.devices.size

    def __eq__(self, other):
        return isinstance(other, Mesh) and other.key == self.key

    def __hash__(self):
        return hash(self.key)


def available_devices(kind: str = "cuda") -> List[torch.device]:
    """The devices a mesh is made of by default: every visible GPU for
    ``"cuda"``, the one CPU device for ``"cpu"``."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"unknown device kind {kind!r}")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(data: int = 1, model: int = 1,
              devices: Union[None, str, Sequence] = None) -> Mesh:
    """Create a (data, model) mesh from the available devices: ``devices``
    is a list (it may repeat a device), ``"cuda"`` (the default: every
    visible GPU) or ``"cpu"``."""
    if devices is None or isinstance(devices, str):
        devices = available_devices(devices or "cuda")
    devices = [torch.device(d) for d in devices]
    if data * model > len(devices):
        raise ValueError(
            f"mesh ({data} data x {model} model) needs {data * model} devices "
            f"but only {len(devices)} are available"
        )
    arr = np.empty(data * model, dtype=object)
    arr[:] = devices[: data * model]
    return Mesh(arr.reshape(data, model))


def param_spec(path: tuple, value, model_size: int) -> tuple:
    """Partition rule for one parameter or buffer, a ``PartitionSpec`` as a
    tuple (one entry a dim: ``"model"`` or None; ``()`` replicates).

    Channel-last tensors (conv kernels, dense (in, out) kernels, weight
    codes, per-channel quant params of shape (C,)) shard the last axis over
    ``model`` when it divides; everything else replicates."""
    shape = tuple(getattr(value, "shape", ()))
    if not shape or model_size <= 1:
        return ()
    last = shape[-1]
    if last % model_size == 0 and last >= model_size:
        return (None,) * (len(shape) - 1) + ("model",)
    return ()


class Shards(NamedTuple):
    """A tensor's placement on one mesh: its spec and the shard of every
    cell, ``grid[d][m]`` on ``mesh.devices[d, m]`` (cells on one device
    share one shard object where their slices agree)."""

    mesh: Mesh
    spec: tuple
    grid: Tuple[Tuple[torch.Tensor, ...], ...]
    version: int


def _cell_index(shape, spec, mesh: Mesh, d: int, m: int):
    index = []
    for dim, axis in enumerate(spec):
        if axis is None:
            index.append(slice(None))
            continue
        n = mesh.shape[axis]
        w = shape[dim] // n
        i = d if axis == "data" else m
        index.append(slice(i * w, (i + 1) * w))
    return tuple(index)


def split(t: torch.Tensor, mesh: Mesh, spec: tuple) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """The shard of every cell of ``mesh`` under ``spec``, each contiguous
    on its cell's device, one copy per distinct (slice, device)."""
    made: Dict[tuple, torch.Tensor] = {}
    grid = []
    for d in range(mesh.shape["data"]):
        row = []
        for m in range(mesh.shape["model"]):
            index = _cell_index(t.shape, spec, mesh, d, m)
            dev = mesh.devices[d, m]
            key = (tuple((s.start, s.stop) for s in index), str(dev))
            if key not in made:
                # a view of a detached alias: a shard that shares t's storage
                # holds no reference back to t (no cycle through t's
                # placement), and shares its version counter
                piece = t.detach()[index]
                made[key] = piece.contiguous().to(dev)
            row.append(made[key])
        grid.append(tuple(row))
    return tuple(grid)


def place(t: torch.Tensor, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """Store ``t``'s shards on ``mesh`` under ``spec`` beside ``t`` and
    return ``t``. A spec axis that does not divide its dim raises."""
    for dim, axis in enumerate(spec):
        if axis is not None and t.shape[dim] % mesh.shape[axis]:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide over "
                             f"{axis} ({mesh.shape[axis]})")
    with torch.no_grad():
        grid = split(t, mesh, spec)
    placed = getattr(t, "_mesh_shards", None)
    if placed is None:
        placed = {}
        t._mesh_shards = placed
    placed[mesh.key] = Shards(mesh, spec, grid, t._version)
    return t


def shards_of(t: torch.Tensor, mesh: Mesh) -> Optional[Shards]:
    """``t``'s placement on ``mesh``, or None where it has none or was
    written in place since it was placed."""
    sh = getattr(t, "_mesh_shards", {}).get(mesh.key)
    if sh is None or sh.version != t._version:
        return None
    return sh


def _named_tensors(variables) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(variables, nn.Module):
        seen, out = set(), []
        for name, t in list(variables.named_parameters()) + list(variables.named_buffers()):
            if id(t) not in seen:
                seen.add(id(t))
                out.append((name, t))
        return out
    if isinstance(variables, Mapping):
        out = []
        for k, v in variables.items():
            out += [(f"{k}.{n}" if n else str(k), t) for n, t in _named_tensors(v)]
        return out
    if isinstance(variables, torch.Tensor):
        return [("", variables)]
    return []


def shard_variables(variables, mesh: Mesh):
    """Place the ``PARTITIONED`` tensors of a module's buffers (or of a
    mapping of tensors, by key) on the mesh per :func:`param_spec`: their
    last axis shards over ``model`` where it divides, else they replicate.
    No other tensor is placed: the part of a step that reads them runs on
    the mesh's first device. Returns ``variables``, whose tensors stay whole
    on their own device."""
    model_size = mesh.shape["model"]
    for name, t in _named_tensors(variables):
        if name.rsplit(".", 1)[-1] in PARTITIONED:
            place(t, mesh, param_spec(tuple(name.split(".")), t, model_size))
    return variables


def reshard(variables, mesh: Mesh):
    """Place ``variables`` on ``mesh`` and drop their placements on any
    other mesh: the same rule as :func:`shard_variables`, for a model that
    moves to another mesh (a batcher over a mesh reshards its model, so a
    model keeps the shards of the last mesh it was served on; the sharded
    kernels split weights with no placement on their mesh at every call,
    counted in ``shard_kernels.CALLS["split_on_call"]``)."""
    for _, t in _named_tensors(variables):
        placed = getattr(t, "_mesh_shards", None)
        if placed:
            for key in [k for k in placed if k != mesh.key]:
                del placed[key]
    return shard_variables(variables, mesh)


def _map(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    if isinstance(x, Mapping):
        return {k: _map(fn, v) for k, v in x.items()}
    return fn(x)


def shard_batch(x, mesh: Mesh):
    """Shard the leading (batch) axis of each array in ``x`` (a tensor, a
    numpy array or a tuple, list or dict of them) over ``data``, where it
    divides; replicate it otherwise. Returns the whole tensors on the
    mesh's first device, each with its placement."""

    def one(v):
        t = torch.as_tensor(v, device=mesh.first)
        if t.ndim >= 1 and t.shape[0] % mesh.shape["data"] == 0:
            spec = ("data",) + (None,) * (t.ndim - 1)
        else:
            spec = ()
        return place(t, mesh, spec)

    return _map(one, x)


def replicate(x, mesh: Mesh):
    """Place a full copy of each tensor in ``x`` on every distinct device
    of the mesh."""

    def one(v):
        t = torch.as_tensor(v, device=mesh.first)
        return place(t, mesh, ())

    return _map(one, x)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Multi-host launch: ``torch.distributed.init_process_group`` joins the
    processes (``coordinator_address`` ``host:port``, or the launcher's
    ``MASTER_ADDR``/``WORLD_SIZE``/``RANK`` environment) and returns this
    process's rank. A single process, with neither, returns 0 and starts
    nothing."""
    import torch.distributed as dist

    if coordinator_address is None and num_processes is None:
        if not {"MASTER_ADDR", "WORLD_SIZE", "RANK"} <= set(os.environ):
            return 0
        if not dist.is_initialized():
            dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo")
        return dist.get_rank()
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id or 0)
    return dist.get_rank()
