"""A multi-device dry run of the mesh paths at tiny shapes, the port's
counterpart of ``__graft_entry__.py::dryrun_multichip``.

Over a ``(2, n/2)`` mesh (``(1, n)`` for an odd n): MobileNetV2 at 64 px
calibrated and evaluated on a data-sharded batch; a quantized Llama
calibrated, then a decode step, a paged decode step and a ring prefill
over an ``(n, 1)`` mesh; then a packed FP8 decode step (K4) and a w4a8
decode step (K5) under ``partitioned_kernels``, where every product's shapes
divide the mesh, so that ``shard_kernels.CALLS`` must count no unsharded
call and no weight split at a call. The JAX dry run asserts instead that
XLA rematerializes nothing involuntarily. Run it on a virtual mesh with
``devices=[torch.device("cpu")] * 8`` (the plain versions), or on the
card with ``[torch.device("cuda", 0)] * 8`` (the kernels).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import EstimatorConfig, FP8Config, QMethod, QuantConfig, RangeMethod, RunMethodConfig
from . import shard_kernels
from .sharding import make_mesh, reshard, shard_batch


def _qc() -> QuantConfig:
    """The canonical FP8 E3M4 configuration (``scripts/image_net.sh``)."""
    return QuantConfig(
        method=QMethod.fp_quantizer, per_channel_weights=True, quantize_input=True,
        weight_range=EstimatorConfig(RangeMethod.current_minmax),
        act_range=EstimatorConfig(RangeMethod.allminmax),
        fp8=FP8Config(set_maxval=True, mse_include_mantissa_bits=False, mantissa_bits=4),
        run_method=RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True))


def _w4a8_qc() -> QuantConfig:
    """``scripts/bench_llama_big.py``'s int4 weights and int8 acts."""
    return QuantConfig(
        method=QMethod.symmetric_uniform, n_bits=4, n_bits_act=8, per_channel_weights=True,
        quantize_input=True, weight_range=EstimatorConfig(RangeMethod.current_minmax),
        act_range=EstimatorConfig(RangeMethod.allminmax),
        run_method=RunMethodConfig(res_quantizer_flag=True))


@torch.no_grad()
def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """Run each mesh path once over ``n_devices`` of ``devices`` (default:
    the visible GPUs) and assert the shapes and the partitioned calls.
    Returns the shapes and ``shard_kernels.CALLS`` of the packed steps."""
    from ..models.llama import KVCache, LlamaSpec, QuantizedLlama
    from ..models.mobilenet_v2 import MobileNetV2Spec, QuantizedMobileNetV2
    from ..models.paged_kv import PagedKVCache
    from ..models.serving import pack_llama
    from ..quant.sites import ESTIMATE, FIXED, QuantPhase

    # the first n_devices of the list (raises where there are fewer)
    devices = make_mesh(n_devices, 1, devices).devices[:, 0].tolist()
    data = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(data=data, model=n_devices // data, devices=devices)
    dev = mesh.first
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # MobileNetV2: calibration and eval on a data-sharded batch
    size = 64
    cnn = QuantizedMobileNetV2(_qc(), MobileNetV2Spec(num_classes=64, image_size=size),
                               generator=gen, device=dev)
    x = torch.zeros((data * 2, size, size, 3), device=dev)
    cnn(x[:1], ESTIMATE)                       # the init forward
    xs = shard_batch(x, mesh)
    cnn(xs, ESTIMATE)
    logits = cnn(xs, FIXED)
    assert logits.shape == (data * 2, 64), logits.shape
    out["cnn"] = tuple(logits.shape)

    # Llama: calibration, a decode step and a paged decode step
    spec = LlamaSpec(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                     num_kv_heads=2, mlp_dim=64, max_seq_len=32)
    llama = QuantizedLlama(_qc(), spec, generator=gen, device=dev)
    tokens = torch.zeros((data * 2, 4), dtype=torch.int64, device=dev)
    ts = shard_batch(tokens, mesh)
    cache = KVCache.zeros(spec, data * 2, spec.max_seq_len, device=dev)
    _, cache2 = llama(ts, cache, ESTIMATE)
    logits, _ = llama(ts[:, :1], cache2, FIXED)
    assert logits.shape == (data * 2, 1, 128), logits.shape
    # four pages a slot and the trash page
    pcache = PagedKVCache.zeros(spec, data * 2, num_pages=1 + data * 2 * 4, page_size=8,
                                device=dev)
    table = torch.arange(1, 1 + data * 2 * 4, dtype=torch.int32, device=dev).reshape(data * 2, 4)
    plogits, _ = llama(ts[:, :1], pcache._replace(page_table=table), FIXED)
    assert plogits.shape == (data * 2, 1, 128), plogits.shape
    out["llama decode"] = tuple(logits.shape)
    out["paged decode"] = tuple(plogits.shape)

    # ring prefill: sequence-parallel over the whole device ring
    ring_mesh = make_mesh(data=n_devices, model=1, devices=devices)
    llama.ring_spec = (ring_mesh, "data")
    rtokens = torch.zeros((2, n_devices * 2), dtype=torch.int64, device=dev)
    rlogits, _ = llama(rtokens, KVCache.zeros(spec, 2, spec.max_seq_len, device=dev), FIXED)
    llama.ring_spec = None
    assert rlogits.shape == (2, n_devices * 2, 128), rlogits.shape
    out["ring prefill"] = tuple(rlogits.shape)

    # packed FP8 (K4) and w4a8 (K5) decode steps under partitioned_kernels:
    # every product's N divides over model and its 2 * data rows over data
    packed = QuantPhase(phase="fixed", fast=True, packed=True)
    llama(ts[:, :1], cache2, QuantPhase(phase="fixed", fast=True, cache_weights=True))
    pack_llama(llama)
    w4 = QuantizedLlama(_w4a8_qc(), spec, generator=gen, device=dev)
    w4(ts, KVCache.zeros(spec, data * 2, spec.max_seq_len, device=dev), ESTIMATE)
    w4(ts[:, :1], KVCache.zeros(spec, data * 2, spec.max_seq_len, device=dev),
       QuantPhase(phase="fixed", fast=True, cache_weights=True))
    pack_llama(w4)
    for name, model, kv in (("packed decode", llama, torch.uint8),
                            ("w4a8 decode", w4, torch.bfloat16)):
        reshard(model, mesh)
        shard_kernels.reset_calls()
        with shard_kernels.partitioned_kernels(mesh):
            klogits, _ = model(ts[:, :1], KVCache.zeros(spec, data * 2, spec.max_seq_len,
                                                        dtype=kv, device=dev), packed)
        assert klogits.shape == (data * 2, 1, 128), klogits.shape
        calls = dict(shard_kernels.CALLS)
        products = 7 * spec.num_layers + 1
        assert calls == {"partitioned": products, "unsharded": 0, "split_on_call": 0}, calls
        out[name] = {"shape": tuple(klogits.shape), **calls}
    return out
