"""The port's Llama serving under a mesh on a virtual mesh of eight CPU
devices: the serving cases of ``tests/test_parallel.py`` for speculative
decoding and prefix-cached admissions on bf16 and packed KV caches (the
speculative batchers are in ``test_torch_parallel_spec.py``), and the
packed FP8 (K4) and w4a8 (K5) batchers whose products run per shard.

JAX calibrates ``tests/test_parallel.py``'s Llama (``_llama_parts``: vocab
64, hidden 32, two layers) and serves it on one device; ``models.bridge``
carries the calibrated variables into the port. Every mesh run of the port
must give the tokens of the same run without a mesh and JAX's
single-device tokens, the JAX test's own rule (token equality).
Stochastic speculation draws from a ``torch.Generator``, not JAX's keys,
so that case holds the mesh run to the port's own run without a mesh,
with rejections in both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_serving import uniform_qc
from test_torch_llama import numpy_tree, qc

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.models.llama import KVCache as JCache
from fp8_quantization_tpu.models.llama import LlamaSpec as JSpec
from fp8_quantization_tpu.models.llama import QuantizedLlama as JLlama
from fp8_quantization_tpu.models.serving import ContinuousBatcher as JBatcher
from fp8_quantization_tpu.models.speculative import SpeculativeDecoder as JDecoder
from fp8_quantization_tpu.quant import ESTIMATE as J_ESTIMATE
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.llama import LlamaSpec, QuantizedLlama
from fp8_quantization_tpu_torch.models.prefix_cache import PrefixCache
from fp8_quantization_tpu_torch.models.sampling import SamplingParams
from fp8_quantization_tpu_torch.models.serving import (ContinuousBatcher, calibrate_llama,
                                                       pack_llama)
from fp8_quantization_tpu_torch.models.speculative import SpeculativeDecoder
from fp8_quantization_tpu_torch.parallel import make_mesh, shard_kernels
from fp8_quantization_tpu_torch.quant.sites import QuantPhase

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

CPU8 = [torch.device("cpu")] * 8
SPEC = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            mlp_dim=64, max_seq_len=64)


def mesh(data, model):
    return make_mesh(data=data, model=model, devices=CPU8[:data * model])


@functools.lru_cache(maxsize=None)
def _jax_programs():
    """The JAX model and its jitted init and ESTIMATE forward, shared by
    every set of parts (one compile each)."""
    spec = JSpec(**SPEC)
    model = JLlama(qc=qc(jc), spec=spec)
    cache = JCache.zeros(spec, 1, spec.max_seq_len)
    init = jax.jit(lambda key, toks: model.init(key, toks, cache, J_ESTIMATE))
    est = jax.jit(lambda v, toks: model.apply(v, toks, cache, J_ESTIMATE,
                                              mutable=["quant", "quant_est"])[1])
    return spec, model, init, est


def _jax_parts(rng, init_key):
    """``tests/test_parallel.py::_llama_parts``: init and an ESTIMATE
    forward of ten random tokens."""
    spec, model, init, est = _jax_programs()
    toks = jnp.asarray(rng.integers(0, spec.vocab_size, size=(1, 10)), jnp.int32)
    v = init(jax.random.key(init_key), toks)
    return spec, model, {**v, **est(v, toks)}


def _port(variables, packed_kv=False):
    model = QuantizedLlama(qc(tc), LlamaSpec(**SPEC), packed_kv=packed_kv)
    model.load_state_dict(from_jax_variables(numpy_tree(variables)), strict=True)
    return model


@pytest.fixture(scope="module")
def target():
    """The JAX target's parts, drawn as ``tests/test_parallel.py`` draws
    them from its ``rng`` fixture."""
    return _jax_parts(np.random.default_rng(10), 0)


def port_draft():
    """A draft of other weights for the port-only stochastic case: seeded
    and calibrated by the port."""
    model = QuantizedLlama(qc(tc), LlamaSpec(**SPEC), generator=torch.Generator().manual_seed(1))
    calibrate_llama(model, np.random.default_rng(1).integers(0, 64, (1, 10)))
    return model


def _serve(batcher, prompts, new):
    out = []
    for p in prompts:
        s = batcher.admit(p, max_new_tokens=new)
        batcher.run_to_completion()
        out.append(batcher.retire(s))
    return out


def test_sharded_speculative_decode_matches_single_device(target):
    """Greedy speculative decoding over a (1, 8) mesh emits the port's and
    JAX's single-device tokens."""
    spec, jm, jv = target
    prompt = [3, 1, 4, 1, 5]
    want = JDecoder(jm, jv, spec, jm, jv, spec, k=3).generate(prompt, max_new_tokens=8)[0]
    tm = _port(jv)
    plain = SpeculativeDecoder(tm, tm.spec, tm, tm.spec, k=3).generate(prompt, 8)[0]
    got = SpeculativeDecoder(tm, tm.spec, tm, tm.spec, k=3, mesh=mesh(1, 8)).generate(
        prompt, 8)[0]
    assert got == plain == [int(t) for t in want]


def test_sharded_stochastic_speculative_matches_single_device(target):
    """Stochastic speculation (temperature 0.8, top-k 16) with a draft of
    other weights over a (1, 8) mesh emits the tokens of the port's run
    without a mesh, with rejections in both."""
    tm, dm = _port(target[2]), port_draft()
    sp = SamplingParams(temperature=0.8, top_k=16)

    def run(m):
        toks, stats = SpeculativeDecoder(tm, tm.spec, dm, dm.spec, k=3, sampling=sp, seed=7,
                                         mesh=m).generate([3, 1, 4, 1, 5], max_new_tokens=8)
        assert stats.accepted < stats.proposed, stats
        return toks

    assert run(mesh(1, 8)) == run(None)


@pytest.mark.parametrize("packed_kv", [False, True], ids=["bf16_kv", "packed_kv"])
def test_sharded_prefix_admission_matches_cold(target, packed_kv):
    """Warm admissions over a (2, 4) mesh, the cached prefix spliced into
    the slot, emit the cold single-device tokens of the port and of JAX;
    the cache hits once. With ``packed_kv`` the byte slabs are spliced
    (``tests/test_parallel.py::test_sharded_prefix_admission_packed_kv``;
    the target's calibrated state serves both cache layouts)."""
    rng = np.random.default_rng(11)
    spec, jm, jv = target
    if packed_kv:
        jm = JLlama(qc=qc(jc), spec=spec, packed_kv=True)
        shared = list(rng.integers(0, 64, size=16))
        prompts, new = [shared + [1, 2], shared + [3]], 5
    else:
        shared = list(rng.integers(0, 64, size=20))
        prompts, new = [shared + [11, 12, 13], shared + [31, 32]], 6
    want = _serve(JBatcher(jm, jv, spec, slots=2, max_seq=spec.max_seq_len), prompts, new)
    tm = _port(jv, packed_kv)
    cold = _serve(ContinuousBatcher(tm, tm.spec, slots=2), prompts, new)
    pc = PrefixCache(max_tokens=256, bucket=16)
    warm = _serve(ContinuousBatcher(tm, tm.spec, slots=2, mesh=mesh(2, 4), prefix_cache=pc),
                  prompts, new)
    assert warm == cold == [[int(t) for t in o] for o in want]
    assert pc.misses == 1 and pc.hits == 1


@pytest.mark.parametrize("kind,shape", [("fp8", (2, 4)), ("w4a8", (1, 4))])
def test_packed_batcher_partitions_every_product(kind, shape):
    """A packed FP8 (K4) or w4a8 (K5) Llama served by ``ContinuousBatcher``
    over a mesh: every product of every forward runs per shard (none
    unsharded, no weight split at a call) and the tokens equal the run
    without a mesh. The smoke runs the same at Llama-3-8B's widths on the
    card."""
    tqc = qc(tc) if kind == "fp8" else uniform_qc(tc, n_bits=4, n_bits_act=8)
    model = QuantizedLlama(tqc, LlamaSpec(**SPEC), generator=torch.Generator().manual_seed(3))
    calibrate_llama(model, np.random.default_rng(4).integers(0, 64, (2, 16)))
    pack_llama(model)
    qp = QuantPhase(phase="fixed", fast=True, packed=True, fused_sdpa=True)
    prompts = [[5, 9, 2], [7] * 20, [1, 2, 3, 4], [60, 61]]

    def run(m):
        b = ContinuousBatcher(model, model.spec, slots=4, qp=qp, mesh=m)
        shard_kernels.reset_calls()
        slots = [b.admit(p, max_new_tokens=5) for p in prompts]
        b.run_to_completion()
        return [b.retire(s) for s in slots], dict(shard_kernels.CALLS)

    plain, _ = run(None)
    toks, calls = run(mesh(*shape))
    forwards = len(prompts) + 4                   # the admissions and four decode steps
    assert calls == {"partitioned": (7 * 2 + 1) * forwards, "unsharded": 0, "split_on_call": 0}
    assert toks == plain
