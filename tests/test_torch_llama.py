"""The port's quantized Llama against the JAX package's, at the spec of
``tests/test_llama.py`` (vocab 64, hidden 32, 2 layers, 4 heads, 2 KV heads,
MLP 64, 48 cache slots) and its FP8 configuration (E3M4, per-channel
current-minmax weights, allminmax acts, quantize-input, res-quantizer with
``original_quantize_res``).

JAX initializes, calibrates (``ESTIMATE``) and caches the weights (a fast
``cache_weights`` forward); ``models.bridge`` carries those variables into
the port, and the port's ``calibrate_llama`` repeats the sequence from the
carried init. Where JAX reaches a Pallas kernel (``fused_sdpa=True``), it runs
it in interpret mode on the CPU; the port runs the kernels' plain versions.

Tolerances:

* calibrated site state: ``rtol=atol=1e-6``; FIXED logits: ``1e-4``. Sums
  run in another order in the two frameworks, and XLA's CPU ``rsqrt``,
  ``exp``, ``cos``/``sin`` and ``pow`` are not correctly rounded, so RMSNorm,
  softmax, SiLU and RoPE outputs differ from PyTorch's by a few ulps; where
  such a value sits on an FP8 rounding midpoint it lands one grid step
  apart. ``SEED`` is one where none does (the logits are then equal).
* KV caches: layer 0's is bit-equal (its K/V come before any attention).
* FAST+fused and PACKED+packed_kv+fused logits: the same argmax and a
  relative RMS below 1e-2: the Pallas kernels and the port's plain versions
  round at the same points but sum in other orders, with the ulps above,
  and a context on an FP8 midpoint then lands one grid step apart (the JAX
  package's own fused-vs-einsum contract is 0.1, ``tests/test_llama.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.models.llama import KVCache as JCache
from fp8_quantization_tpu.models.llama import LlamaSpec as JSpec
from fp8_quantization_tpu.models.llama import QuantizedLlama as JLlama
from fp8_quantization_tpu.ops.fastpath import pack_dense_caches as j_pack
from fp8_quantization_tpu.ops.fastpath import strip_packed_params as j_strip
from fp8_quantization_tpu.ops.pallas import dequant_matmul as j_dequant
from fp8_quantization_tpu.quant.sites import QuantPhase as JPhase
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.llama import (
    LLAMA3_8B,
    KVCache,
    LlamaSpec,
    QuantizedLlama,
    write_rows,
)
from fp8_quantization_tpu_torch.models.serving import calibrate_llama, pack_llama
from fp8_quantization_tpu_torch.quant.sites import FIXED, QuantPhase

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

SEED = 10
SPEC = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
            mlp_dim=64, max_seq_len=48)
S = SPEC["max_seq_len"]
STATE_TOL = dict(rtol=1e-6, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

J_FAST_FUSED = JPhase(phase="fixed", fast=True, fused_sdpa=True)
J_PACKED_FUSED = JPhase(phase="fixed", fast=True, packed=True, fused_sdpa=True)
T_FAST_FUSED = QuantPhase(phase="fixed", fast=True, fused_sdpa=True)
T_PACKED_FUSED = QuantPhase(phase="fixed", fast=True, packed=True, fused_sdpa=True)


def qc(mod):
    """``tests/test_llama.py``'s configuration."""
    return mod.QuantConfig(
        method=mod.QMethod.fp_quantizer, per_channel_weights=True, quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, dict(tree))


class JaxSide:
    """The JAX model calibrated as ``scripts/bench_llama.py`` does (init, an
    ESTIMATE forward, a fast ``cache_weights`` forward), all jitted, at
    ``SPEC`` or the given spec keywords."""

    def __init__(self, calib, spec=SPEC):
        self.spec = JSpec(**spec)
        self.model = JLlama(qc=qc(jc), spec=self.spec)
        self.packed_model = JLlama(qc=qc(jc), spec=self.spec, packed_kv=True)
        calib = jnp.asarray(calib)
        cache = JCache.zeros(self.spec, calib.shape[0], S)
        est = JPhase(phase="estimate")
        self.init = jax.jit(self.model.init, static_argnums=3)(
            jax.random.key(0), calib, cache, est)
        _, ups = jax.jit(lambda v: self.model.apply(
            v, calib, cache, est, mutable=["quant", "quant_est"]))(self.init)
        self.calibrated = {**self.init, **ups}
        warm = JPhase(phase="fixed", fast=True, cache_weights=True)
        _, ups = jax.jit(lambda v: self.model.apply(
            v, calib, cache, warm, mutable=["quant_cache"]))(self.calibrated)
        self.cached = {**self.calibrated, **ups}
        self._packed = None
        self._apply = {}

    @property
    def packed(self):
        """``cached`` packed to 1-byte weight codes and stripped, with the
        per-layer packing jitted (the JAX package's function, unchanged)."""
        if self._packed is None:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(j_dequant, "pack_weights",
                           jax.jit(j_dequant.pack_weights, static_argnums=(2, 3)))
                self._packed = j_strip(j_pack(self.cached, qc(jc))[0])
        return self._packed

    def apply(self, packed_kv, variables, tokens, cache, qp, chunk_attention=False):
        key = (packed_kv, qp, chunk_attention)
        if key not in self._apply:
            model = self.packed_model if packed_kv else self.model
            self._apply[key] = jax.jit(
                lambda v, t, c: model.apply(v, t, c, qp, chunk_attention=chunk_attention))
        logits, cache = self._apply[key](variables, jnp.asarray(tokens), cache)
        return np.asarray(logits, np.float32), cache


def torch_model(variables, packed_kv=False, spec=SPEC):
    model = QuantizedLlama(qc(tc), LlamaSpec(**spec), packed_kv=packed_kv)
    model.load_state_dict(from_jax_variables(numpy_tree(variables)), strict=True)
    return model


@pytest.fixture(scope="module")
def sides():
    rng = np.random.default_rng(SEED)
    calib = rng.integers(0, SPEC["vocab_size"], size=(2, 12)).astype(np.int32)
    j = JaxSide(calib)
    return j, calib, rng.integers(0, SPEC["vocab_size"], size=(2, 16)).astype(np.int64)


def t_cache(batch, packed_kv=False, length=None):
    cache = KVCache.zeros(LlamaSpec(**SPEC), batch, S,
                          dtype=torch.uint8 if packed_kv else torch.bfloat16)
    if length is not None:
        cache = cache._replace(length=torch.tensor(length, dtype=torch.int32))
    return cache


def j_cache(batch, packed_kv=False, length=None):
    cache = JCache.zeros(JSpec(**SPEC), batch, S,
                         dtype=jnp.uint8 if packed_kv else jnp.bfloat16)
    if length is not None:
        cache = cache._replace(length=jnp.asarray(length, jnp.int32))
    return cache


def test_spec_is_the_jax_packages():
    assert LLAMA3_8B == LlamaSpec() and LlamaSpec().head_dim == 128
    assert (LLAMA3_8B.vocab_size, LLAMA3_8B.num_layers, LLAMA3_8B.num_kv_heads,
            LLAMA3_8B.mlp_dim, LLAMA3_8B.rope_theta) == (128256, 32, 8, 14336, 500000.0)


def test_estimate_gives_the_jax_site_state(sides):
    """The JAX init carried across, then the port's own ``calibrate_llama``
    (ESTIMATE, then the FAST ``cache_weights`` forward) on the calibration
    tokens: every site's state and every bf16 weight cache as JAX leaves
    them."""
    j, calib, _ = sides
    model = torch_model(j.init)
    calibrate_llama(model, calib)
    expect = from_jax_variables(numpy_tree(
        {k: j.cached[k] for k in ("quant", "quant_est", "quant_cache")}))
    got = model.state_dict()
    assert expect.keys() <= got.keys()
    assert any("k_cache_quantizer" in key for key in expect)
    assert sum(key.endswith("w_q") for key in expect) == 7 * SPEC["num_layers"] + 1
    for key, value in expect.items():
        torch.testing.assert_close(got[key], value, msg=key, **STATE_TOL)


def test_fixed_logits_match_jax(sides):
    j, _, seq = sides
    model = torch_model(j.calibrated)
    with torch.no_grad():
        logits, cache = model(torch.from_numpy(seq[:, :10]), t_cache(2), FIXED)
    j_logits, j_c = j.apply(False, j.calibrated, seq[:, :10], j_cache(2), JPhase())
    assert logits.shape == (2, 10, SPEC["vocab_size"]) and torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), j_logits, **LOGIT_TOL)
    assert cache.length.tolist() == [10, 10]


def test_prefill_then_decode_matches_full_forward(sides):
    j, _, seq = sides
    model = torch_model(j.calibrated)
    x = torch.from_numpy(seq[:1, :10])
    with torch.no_grad():
        full, _ = model(x, t_cache(1), FIXED)
        pre, cache = model(x[:, :6], t_cache(1), FIXED)
        np.testing.assert_allclose(pre.numpy(), full[:, :6].numpy(), rtol=1e-4, atol=1e-4)
        for i in range(6, 10):
            step, cache = model(x[:, i:i + 1], cache, FIXED)
            np.testing.assert_allclose(step[:, 0].numpy(), full[:, i].numpy(),
                                       rtol=1e-3, atol=1e-3)
    assert cache.length.tolist() == [10]


def test_chunk_attention_is_value_identical(sides):
    j, _, seq = sides
    model = torch_model(j.calibrated)
    x = torch.from_numpy(seq[:, :9])
    with torch.no_grad():
        a, ca = model(x, t_cache(2), FIXED)
        b, cb = model(x, t_cache(2), FIXED, chunk_attention=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(ca.k, cb.k) and torch.equal(ca.v, cb.v)


@pytest.mark.parametrize("packed_kv", [False, True], ids=["bf16", "packed_kv"])
def test_layer0_kv_cache_is_bit_equal_to_jax(sides, packed_kv):
    """A FAST prefill: layer 0's cached K/V (bf16 grid values, or uint8
    codes on the sites' packing biases) equal JAX's bit for bit."""
    j, _, seq = sides
    model = torch_model(j.cached, packed_kv=packed_kv)
    fast = QuantPhase(phase="fixed", fast=True)
    with torch.no_grad():
        _, cache = model(torch.from_numpy(seq[:, :12]), t_cache(2, packed_kv), fast)
    _, jcache = j.apply(packed_kv, j.cached, seq[:, :12], j_cache(2, packed_kv),
                        JPhase(phase="fixed", fast=True))
    want = torch.uint8 if packed_kv else torch.bfloat16
    assert cache.k.dtype == want
    for ours, theirs in ((cache.k, jcache.k), (cache.v, jcache.v)):
        theirs = np.asarray(theirs)
        if not packed_kv:
            theirs = theirs.view(np.uint16)
            ours = ours.view(torch.int16)
        np.testing.assert_array_equal(ours[0].numpy().view(theirs.dtype), theirs[0])


def _rel_rms(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()) / b.std())


def _close(ours, ref):
    assert np.isfinite(ours).all() and ours.shape == ref.shape
    assert _rel_rms(ours, ref) < 1e-2, _rel_rms(ours, ref)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("mode", ["fast", "packed_kv"])
def test_serving_logits_through_the_attention_kernels_match_jax(sides, mode):
    """FAST+fused (bf16 KV) and PACKED+packed_kv+fused (1-byte weights and
    uint8 KV): a cold chunk prefill (K7), three decode steps (K6) and a warm
    chunk over the slab with per-slot offsets (K7), against JAX's Pallas
    kernels in interpret mode."""
    j, _, seq = sides
    packed_kv = mode == "packed_kv"
    if packed_kv:
        model = torch_model(j.cached)
        pack_llama(model)
        variables, t_qp, j_qp = j.packed, T_PACKED_FUSED, J_PACKED_FUSED
        # the port's packing gives JAX's weight codes, which the bridge carries
        theirs = from_jax_variables(numpy_tree({"quant_cache": j.packed["quant_cache"]}))
        codes = [key for key in theirs if key.endswith(("w_codes", "w_pack_bias"))]
        assert len(codes) == 2 * (7 * SPEC["num_layers"] + 1)
        ours = model.state_dict()
        for key in codes:
            assert torch.equal(ours[key], theirs[key]), key
    else:
        model = torch_model(j.cached)
        variables, t_qp, j_qp = j.cached, T_FAST_FUSED, J_FAST_FUSED
    cache, jcache = t_cache(2, packed_kv), j_cache(2, packed_kv)
    chunks = [(seq[:, :9], True)] + [(seq[:, i:i + 1], False) for i in (9, 10, 11)]
    chunks.append((seq[:, 12:16], False))
    for tokens, chunk_attention in chunks:
        with torch.no_grad():
            logits, cache = model(torch.from_numpy(tokens), cache, t_qp,
                                  chunk_attention=chunk_attention)
        j_logits, jcache = j.apply(packed_kv, variables, tokens, jcache, j_qp,
                                   chunk_attention=chunk_attention)
        _close(logits.float().numpy(), j_logits)
    assert cache.length.tolist() == [16, 16]


def test_cache_write_clamps_its_start_as_jax(sides):
    """A 4-token chunk written at length 46 of 48 slots: the start clamps to
    44 (``lax.dynamic_update_slice``), in both packages."""
    j, _, seq = sides
    model = torch_model(j.calibrated)
    with torch.no_grad():
        _, cache = model(torch.from_numpy(seq[:1, :4]), t_cache(1, length=[46]), FIXED)
    _, jcache = j.apply(False, j.calibrated, seq[:1, :4], j_cache(1, length=[46]),
                        JPhase())
    theirs = np.asarray(jcache.k).view(np.uint16)
    np.testing.assert_array_equal(cache.k[0].view(torch.int16).numpy().view(np.uint16),
                                  theirs[0])
    assert bool((cache.k[:, 0, 44:] != 0).any()) and not bool((cache.k[:, 0, :44] != 0).any())
    slab = torch.zeros((2, 6, 1, 1))
    write_rows(slab, torch.ones((2, 3, 1, 1)), torch.tensor([1, 5]))
    assert slab[:, :, 0, 0].tolist() == [[0, 1, 1, 1, 0, 0], [0, 0, 0, 1, 1, 1]]


def test_packed_kv_toggles_on_the_same_modules(sides):
    j, _, _ = sides
    model = torch_model(j.cached)
    before = model.state_dict()
    model.packed_kv = True
    assert all(getattr(model, f"layer_{i}").packed_kv for i in range(SPEC["num_layers"]))
    after = model.state_dict()
    assert all(after[k].data_ptr() == v.data_ptr() for k, v in before.items())
    with pytest.raises(TypeError, match="uint8"):
        model(torch.zeros((1, 2), dtype=torch.long), t_cache(1), FIXED)


def test_later_slices_raise():
    """Ring prefill and the mesh-sharded paged batcher, which belonged to a
    later slice, are ported: ``ring_spec`` reaches every block, and a paged
    batcher takes a mesh whose ``data`` axis divides its slots (else it
    raises as the JAX batcher does). Their runs are held in
    ``test_torch_ring_attention.py`` and ``test_torch_parallel_spec.py``."""
    from fp8_quantization_tpu_torch.models.paged_kv import PagedBatcher
    from fp8_quantization_tpu_torch.parallel import make_mesh, sharding

    spec = LlamaSpec(**SPEC)
    mesh = make_mesh(data=2, model=2, devices=[torch.device("cpu")] * 4)
    model = QuantizedLlama(qc(tc), spec, ring_spec=(mesh, "data"))
    assert all(getattr(model, f"layer_{i}").ring_spec == (mesh, "data")
               for i in range(spec.num_layers))
    model.ring_spec = None
    with pytest.raises(ValueError, match="must divide over the data axis"):
        PagedBatcher(model, spec, slots=3, mesh=mesh)
    assert PagedBatcher(model, spec, slots=4, mesh=mesh).mesh is mesh
    # only packed codes are placed: this model is not packed
    assert sharding.shards_of(model.layer_0.q_proj.kernel, mesh) is None
