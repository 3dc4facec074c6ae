"""The port's uniform (int8 and w4a8) serving path against the JAX package's,
on the CPU, from the same numpy inputs.

* The uniform quantizers, their integer grid (``uniform_int_params``), the
  ``Coded`` chained currency, ``quantize_acts_int8``, ``pack_int4`` /
  ``unpack_int4`` and ``quantized_matmul_int8``: bit-equal. ``x / scale`` is
  one IEEE division and both frameworks round half to even; the int32 sums
  are exact.
* K5's plain version: bit-equal to JAX's Pallas ``int4_matmul`` in interpret
  mode and to an int64 numpy product.
* The uniform ``pack_dense_caches`` of a calibrated ``QuantDense``: the
  ``w_i8*`` / ``w_i4*`` buffers equal JAX's ``quant_cache``; its PACKED
  output equals JAX's.
* The tiny Llama of ``tests/test_torch_llama.py`` (vocab 64, hidden 32, 2
  layers, 4 heads, 2 KV heads, MLP 64) in ``scripts/bench_llama_big.py``'s
  w4a8 configuration and in ``scripts/bench_llama.py``'s ``uniform_qc(8)``:
  the port's ``calibrate_llama`` from the bridged JAX init gives JAX's site
  state within ``STATE_TOL`` (``rtol=atol=1e-6``) and ``pack_llama`` JAX's
  integer codes; PACKED prefill and decode logits with ``fused_sdpa=True``
  within ``LOGIT_TOL`` (``rtol=atol=1e-4``); the port's CHAINED logits equal
  its PACKED ones bit for bit; ``ContinuousBatcher`` greedy tokens equal
  JAX's. The tolerances are ``test_torch_llama.py``'s, for its reasons:
  XLA's CPU ``rsqrt``, ``exp`` and ``cos``/``sin`` differ from PyTorch's by
  a few ulps, and a value that sits on a grid midpoint then lands one int8
  code apart. ``SEED`` is one where none does.

On the CPU every kernel wrapper takes its plain version; the launch counters
must not move.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_llama import SPEC, S, numpy_tree

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.models.llama import KVCache as JCache
from fp8_quantization_tpu.models.llama import LlamaSpec as JSpec
from fp8_quantization_tpu.models.llama import QuantizedLlama as JLlama
from fp8_quantization_tpu.models.serving import ContinuousBatcher as JBatcher
from fp8_quantization_tpu.ops import fastpath as jfast
from fp8_quantization_tpu.ops.layers import QuantDense as JDense
from fp8_quantization_tpu.ops.pallas.dequant_matmul import int4_matmul as j_int4_matmul
from fp8_quantization_tpu.quant import quantizers as jq
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import cli as tcli
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.llama import KVCache, LlamaSpec, QuantizedLlama
from fp8_quantization_tpu_torch.models.serving import (
    ContinuousBatcher,
    calibrate_llama,
    pack_llama,
)
from fp8_quantization_tpu_torch.ops import fastpath
from fp8_quantization_tpu_torch.ops.cuda import KERNELS
from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as k5
from fp8_quantization_tpu_torch.ops.layers import QuantDense as TDense
from fp8_quantization_tpu_torch.quant import quantizers as tq
from fp8_quantization_tpu_torch.quant import sites as tsites

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

SEED = 10
STATE_TOL = dict(rtol=1e-6, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

# (method, signed data): symmetric signed, symmetric unsigned (a nonnegative
# range), asymmetric
GRIDS = [("symmetric_uniform", True), ("symmetric_uniform", False),
         ("asymmetric_uniform", True)]
GRID_IDS = ["sym_signed", "sym_unsigned", "asym"]


def _launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


def _qcfg(mod, method, n_bits, per_channel=False, scale_domain="linear"):
    return mod.QuantizerConfig(method=mod.QMethod(method), n_bits=n_bits,
                               per_channel=per_channel, scale_domain=scale_domain)


def _data(rng, shape, signed):
    x = (rng.normal(size=shape) * 2.5).astype(np.float32)
    return x if signed else np.abs(x)


def w4a8_qc(mod):
    """``scripts/bench_llama_big.py::int4_qc``."""
    return mod.QuantConfig(
        method=mod.QMethod.symmetric_uniform, n_bits=4, n_bits_act=8,
        per_channel_weights=True, quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True))


def int8_qc(mod):
    """``scripts/bench_llama.py::uniform_qc(8)``."""
    return mod.QuantConfig(
        method=mod.QMethod.symmetric_uniform, n_bits=8,
        per_channel_weights=True, quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True))


QCS = {"w4a8": w4a8_qc, "int8": int8_qc}


# --------------------------------------------------------------------------
# quantizers, grids and codes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_bits", [4, 8])
@pytest.mark.parametrize("method,signed", GRIDS, ids=GRID_IDS)
def test_uniform_quantizer_matches_jax(rng, method, signed, n_bits):
    """``set_quant_range`` then ``apply``, per tensor and per channel: state
    and values bit-equal. In the log scale domain ``delta`` passes through
    ``log`` and ``exp``, which XLA's CPU rounds a few ulps off PyTorch's:
    the state within ``STATE_TOL`` and the values within one grid step."""
    x = _data(rng, (12, 20), signed)
    for per_channel, domain in ((False, "linear"), (True, "linear"), (False, "log")):
        exact = domain == "linear"
        jcfg = _qcfg(jc, method, n_bits, per_channel, domain)
        tcfg = _qcfg(tc, method, n_bits, per_channel, domain)
        axis = 1 if per_channel else None
        lo, hi = x.min(axis=0 if per_channel else None), x.max(axis=0 if per_channel else None)
        n = x.shape[1] if per_channel else 1
        js = jq.set_quant_range(jcfg, jq.init(jcfg, n), jnp.asarray(lo), jnp.asarray(hi))
        ts = tq.set_quant_range(tcfg, tq.init(tcfg, n), torch.as_tensor(lo),
                                torch.as_tensor(hi))
        assert js.keys() == ts.keys() == {"delta", "zero_float", "signed"}
        for key in js:
            if exact:
                np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]), err_msg=key)
            else:
                np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), err_msg=key,
                                           **STATE_TOL)
        assert int(ts["signed"][0]) == int(signed or method == "asymmetric_uniform")
        jy = np.asarray(jq.apply(jcfg, js, jnp.asarray(x), channel_axis=axis or 0))
        ty = tq.apply(tcfg, ts, torch.from_numpy(x), channel_axis=axis or 0).numpy()
        if exact:
            np.testing.assert_array_equal(ty, jy)
        else:
            step = float(tq.uniform_scale(tcfg, ts["delta"])[0])
            np.testing.assert_allclose(ty, jy, rtol=0, atol=step * 1.001)
    # LSQ gradient scaling (ported with QAT) changes gradients only: the
    # forward is the unscaled one bit for bit, and JAX's within the step
    ty_lsq = tq.apply(tcfg, ts, torch.from_numpy(x), grad_scaling=True).numpy()
    np.testing.assert_array_equal(ty_lsq, ty)
    jy_lsq = np.asarray(jq.apply(jcfg, js, jnp.asarray(x), grad_scaling=True))
    np.testing.assert_allclose(ty_lsq, jy_lsq, rtol=0, atol=step * 1.001)


def _sites(rng, method, signed, n_bits, shape=(64, 32)):
    """A per-tensor act site of each package after the same ESTIMATE
    forwards (flax's ``init`` runs one, then one more), and the batch."""
    jqc = jc.QuantConfig(method=jc.QMethod(method), n_bits=n_bits, quantize_input=True,
                         act_range=jc.EstimatorConfig(jc.RangeMethod.allminmax))
    tqc = tc.QuantConfig(method=tc.QMethod(method), n_bits=n_bits, quantize_input=True,
                         act_range=tc.EstimatorConfig(tc.RangeMethod.allminmax))
    x = _data(rng, shape, signed)
    jsite = jsites.QuantSite(jqc.act_quantizer(), jqc.act_range)
    v = jsite.init(jax.random.key(0), jnp.asarray(x), jsites.ESTIMATE)
    _, ups = jsite.apply(v, jnp.asarray(x), jsites.ESTIMATE, mutable=["quant", "quant_est"])
    v = {**v, **ups}
    tsite = tsites.QuantSite(tqc.act_quantizer(), tqc.act_range)
    with torch.no_grad():
        for _ in range(2):
            tsite(torch.from_numpy(x), tsites.ESTIMATE)
    return jsite, v, tsite, x


@pytest.mark.parametrize("n_bits", [4, 8])
@pytest.mark.parametrize("method,signed", GRIDS, ids=GRID_IDS)
def test_site_grid_and_coded_match_jax(rng, method, signed, n_bits):
    """A calibrated uniform site: its state (the estimator is
    method-independent), ``uniform_int_params``, its values in every phase
    and its ``Coded`` codes equal JAX's; ``decoded`` of the codes is the
    fake-quantized value bit for bit."""
    jsite, v, tsite, x = _sites(rng, method, signed, n_bits)
    expect = from_jax_variables(numpy_tree({k: v[k] for k in ("quant", "quant_est")}))
    got = tsite.state_dict()
    assert expect.keys() == got.keys()
    for key, value in expect.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)
    jp = jsite.apply(v, method=jsites.QuantSite.uniform_int_params)
    for ours, theirs in zip(tsite.uniform_int_params(), jp):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    xj, xt = jnp.asarray(x * 1.3), torch.from_numpy(x * 1.3)   # some values clip
    fake = np.asarray(jsite.apply(v, xj, jsites.FIXED))
    for phase in (tsites.FIXED, tsites.FAST, tsites.PACKED, tsites.CHAINED):
        y = tsite(xt, phase)
        assert y.dtype == torch.float32
        np.testing.assert_array_equal(y.numpy(), fake)
    j_codes = jsite.apply(v, xj, jsites.CHAINED, as_codes=True)
    t_codes = tsite(xt, tsites.CHAINED, as_codes=True)
    assert isinstance(t_codes, tsites.Coded) and t_codes.codes.dtype == torch.int8
    np.testing.assert_array_equal(t_codes.codes.numpy(), np.asarray(j_codes.codes))
    assert float(t_codes.cx) == float(j_codes.cx) and float(t_codes.scale) == float(j_codes.scale)
    np.testing.assert_array_equal(tsites.decoded(t_codes).numpy(), fake)
    assert tsites.coded_shape(t_codes.reshape(-1, 8)) == (x.size // 8, 8)
    # a Coded input is decoded before the site quantizes it again
    np.testing.assert_array_equal(tsite(t_codes, tsites.FIXED).numpy(), fake)


@pytest.mark.parametrize("method,signed", GRIDS, ids=GRID_IDS)
def test_quantize_acts_int8_matches_jax(rng, method, signed):
    jsite, v, tsite, x = _sites(rng, method, signed, 8)
    s, zp, lo, hi = (np.asarray(p) for p in jsite.apply(v, method=jsites.QuantSite.uniform_int_params))
    x = x * 1.5
    j_codes, j_cx = jfast.quantize_acts_int8(jnp.asarray(x), s[0], zp[0], lo[0], hi[0])
    t_codes, t_cx = fastpath.quantize_acts_int8(
        torch.from_numpy(x), *(torch.from_numpy(p.copy())[0] for p in (s, zp, lo, hi)))
    assert t_codes.dtype == torch.int8
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(j_codes))
    assert float(t_cx) == float(j_cx)
    assert int(t_codes.min()) == -128 and int(t_codes.max()) == 127   # the clip is reached


@pytest.mark.parametrize("kk", [64, 63, 1])
def test_pack_int4_matches_jax(rng, kk):
    codes = rng.integers(-8, 8, size=(kk, 24)).astype(np.int8)
    packed = fastpath.pack_int4(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (-(-kk // 2), 24)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jfast.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(fastpath.unpack_int4(packed, kk).numpy(), codes)


@pytest.mark.parametrize("w_has_zp", [False, True], ids=["signed_weights", "zero_points"])
def test_quantized_matmul_int8_matches_jax(rng, w_has_zp):
    m, k, n = 7, 40, 24
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    scale = (rng.uniform(0.5, 2.0, size=n) * 1e-2).astype(np.float32)
    zp = rng.integers(100, 156, size=n).astype(np.float32) if w_has_zp else None
    wsum = w.astype(np.int32).sum(axis=0).astype(np.int32)
    bias = rng.normal(size=n).astype(np.float32)
    sx, cx = np.float32(0.037), np.float32(-128.0 if w_has_zp else 0.0)
    jw = jfast.Int8Weights(codes=jnp.asarray(w), scale=jnp.asarray(scale),
                           zp=None if zp is None else jnp.asarray(zp), wsum=jnp.asarray(wsum))
    tw = fastpath.Int8Weights(codes=torch.from_numpy(w), scale=torch.from_numpy(scale),
                              zp=None if zp is None else torch.from_numpy(zp),
                              wsum=torch.from_numpy(wsum))
    for b in (None, bias):
        want = np.asarray(jfast.quantized_matmul_int8(
            jnp.asarray(x), jw, jnp.float32(sx), jnp.float32(cx),
            bias=None if b is None else jnp.asarray(b), w_has_zp=w_has_zp))
        got = fastpath.quantized_matmul_int8(
            torch.from_numpy(x), tw, torch.tensor(sx), torch.tensor(cx),
            bias=None if b is None else torch.from_numpy(b), w_has_zp=w_has_zp)
        np.testing.assert_array_equal(got.numpy(), want)
    # with the product handed in (as K5 hands it), the codes go unread
    acc = fastpath.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(
        fastpath.quantized_matmul_int8(torch.from_numpy(x), tw._replace(codes=None),
                                       torch.tensor(sx), torch.tensor(cx), acc=acc,
                                       w_has_zp=w_has_zp).numpy(),
        np.asarray(jfast.quantized_matmul_int8(jnp.asarray(x), jw, jnp.float32(sx),
                                               jnp.float32(cx), w_has_zp=w_has_zp)))


@pytest.mark.parametrize("m,k,n", [(9, 96, 136), (5, 97, 40), (1, 1, 3)])
def test_int4_matmul_plain_matches_jax_and_numpy(rng, m, k, n):
    """K5's plain version: the exact int32 product, equal to JAX's Pallas
    kernel in interpret mode and to an int64 numpy product, codes spanning
    the full int8 range for x and [-8, 7] for w (odd K pads a zero row)."""
    w = rng.integers(-8, 8, size=(k, n)).astype(np.int8)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    x[0, :2] = -128
    w4 = np.array(jfast.pack_int4(jnp.asarray(w)))
    before = _launches()
    got = k5.int4_matmul(torch.from_numpy(x), torch.from_numpy(w4), k=k)
    assert _launches() == before and got.dtype == torch.int32
    want = x.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_int4_matmul(jnp.asarray(x), jnp.asarray(w4), k=k)))
    np.testing.assert_array_equal(
        k5.int4_matmul_plain(torch.from_numpy(x), torch.from_numpy(w4), k=k).numpy(),
        got.numpy())
    with pytest.raises(ValueError, match="bad shapes"):
        k5.int4_matmul(torch.from_numpy(x), torch.from_numpy(w4), k=k + 2)
    with pytest.raises(TypeError, match="int8"):
        k5.int4_matmul(torch.from_numpy(x).to(torch.int32), torch.from_numpy(w4), k=k)


# --------------------------------------------------------------------------
# one dense layer: uniform packing and the PACKED output
# --------------------------------------------------------------------------

def _dense_qc(mod, method, n_bits):
    return mod.QuantConfig(
        method=mod.QMethod(method), n_bits=n_bits, n_bits_act=8, per_channel_weights=True,
        quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True))


@pytest.mark.parametrize("method,n_bits,nonneg", [
    ("symmetric_uniform", 4, False), ("symmetric_uniform", 4, True),
    ("symmetric_uniform", 8, False), ("symmetric_uniform", 8, True),
    ("asymmetric_uniform", 8, False)],
    ids=["w4", "w4_unsigned", "w8", "w8_unsigned", "asym_w8"])
def test_uniform_dense_packing_matches_jax(rng, method, n_bits, nonneg):
    """A calibrated QuantDense: ``pack_dense_caches`` gives JAX's integer
    codes, scales, sums and (for a nonnegative kernel, whose grid calibrates
    unsigned, and for the asymmetric grid) zero points; the PACKED and
    CHAINED outputs equal JAX's PACKED output."""
    x = rng.normal(size=(2, 9, 33)).astype(np.float32)
    jqc, tqc = _dense_qc(jc, method, n_bits), _dense_qc(tc, method, n_bits)
    jl = JDense(qc=jqc, features=24)
    v = jl.init(jax.random.key(1), jnp.asarray(x), jsites.ESTIMATE)
    if nonneg:
        v = {**v, "params": {**v["params"], "kernel": jnp.abs(v["params"]["kernel"])}}
    _, ups = jl.apply(v, jnp.asarray(x), jsites.ESTIMATE, mutable=["quant", "quant_est"])
    v = {**v, **ups}
    cache_qp = jsites.QuantPhase(phase="fixed", cache_weights=True, fast=True)
    _, ups = jl.apply(v, jnp.asarray(x), cache_qp, mutable=["quant_cache"])
    vp, report = jfast.pack_dense_caches({**v, **ups}, jqc)
    want = np.asarray(jl.apply(jfast.strip_packed_params(vp), jnp.asarray(x), jsites.PACKED))

    tl = TDense(tqc, 33, 24)
    tl.load_state_dict(from_jax_variables(numpy_tree(
        {k: v[k] for k in ("params", "quant", "quant_est")})), strict=True)
    with torch.no_grad():
        tl(torch.from_numpy(x), tsites.QuantPhase(phase="fixed", cache_weights=True, fast=True))
    assert tl.w_q.dtype == torch.float32     # uniform grids are not bf16-exact
    _, t_report = fastpath.pack_dense_caches(tl, tqc)
    assert t_report == report == {"": 1.0}
    prefix = "w_i4" if n_bits <= 4 else "w_i8"
    theirs = from_jax_variables(numpy_tree({"quant_cache": vp["quant_cache"]}))
    assert (prefix + "_zp" in theirs) == (nonneg or method == "asymmetric_uniform")
    assert {k for k in theirs if k.startswith("w_i")} == {
        k for k in tl.state_dict() if k.startswith("w_i")}
    for key, value in theirs.items():
        ours = tl.state_dict()[key]
        assert ours.dtype == value.dtype, key
        np.testing.assert_array_equal(ours.numpy(), value.numpy(), err_msg=key)
    fastpath.strip_packed_params(tl)
    assert tl.kernel is None and tl.w_q is None
    before = _launches()
    with torch.no_grad():
        packed = tl(torch.from_numpy(x), tsites.PACKED)
        chained = tl(torch.from_numpy(x), tsites.CHAINED)
    assert _launches() == before
    np.testing.assert_array_equal(packed.numpy(), want)
    assert isinstance(chained, tsites.Coded)
    np.testing.assert_array_equal(tsites.decoded(chained).numpy(), want)


def test_uniform_conv_codes_raise_for_the_cnn_slice(tmp_path, monkeypatch):
    """A conv whose input a per-tensor uniform act site quantizes takes int8
    codes (``quantized_conv_int8``), which raised until the CNN serving
    boundary was ported: packing it now gives JAX's kernel-shaped codes, and
    PACKED gives JAX's output bit for bit; ``validate-quantized
    --packed-weights`` with such a configuration runs on a tiny ViT (whose
    patch embedding is that conv) and writes its result file."""
    from fp8_quantization_tpu.ops.layers import QuantConv as JConv
    from fp8_quantization_tpu_torch.models.vit import ViTSpec
    from fp8_quantization_tpu_torch.ops.layers import QuantConv

    x = np.random.default_rng(0).normal(size=(1, 4, 4, 3)).astype(np.float32)
    jm = JConv(qc=_dense_qc(jc, "symmetric_uniform", 8), features=4, kernel_size=(2, 2))
    variables = numpy_tree(jm.init(jax.random.key(0), jnp.asarray(x), jsites.ESTIMATE))
    conv = QuantConv(_dense_qc(tc, "symmetric_uniform", 8), 3, 4, kernel_size=(2, 2))
    conv.load_state_dict(from_jax_variables(variables), strict=True)
    cache = jsites.QuantPhase(phase="fixed", cache_weights=True, fast=True)
    _, ups = jm.apply(variables, jnp.asarray(x), cache, mutable=["quant_cache"])
    jv, _ = jfast.pack_dense_caches({**variables, **ups}, jm.qc)
    with torch.no_grad():
        conv(torch.from_numpy(x), tsites.QuantPhase(phase="fixed", cache_weights=True,
                                                    fast=True))
    fastpath.pack_dense_caches(conv, conv.qc)
    assert conv.w_i8.shape == (2, 2, 3, 4)
    theirs = from_jax_variables(numpy_tree({"quant_cache": jv["quant_cache"]}))
    for key in ("w_i8", "w_i8_scale", "w_i8_sum"):
        np.testing.assert_array_equal(getattr(conv, key).numpy(), theirs[key].numpy(),
                                      err_msg=key)
    with torch.no_grad():
        got = conv(torch.from_numpy(x), tsites.PACKED).numpy()
    np.testing.assert_array_equal(got, np.asarray(jm.apply(jv, jnp.asarray(x), jsites.PACKED)))
    monkeypatch.setattr(tcli, "build_model", functools.partial(tcli.build_model, spec=ViTSpec(
        hidden_size=32, num_layers=1, num_heads=4, mlp_dim=64, patch_size=8, image_size=32,
        num_classes=10)))
    out = tcli.main(["validate-quantized", "--architecture", "vit_quantized",
                     "--synthetic-data", "--no-cuda", "--batch-size", "2",
                     "--max-eval-batches", "1", "--qmethod", "symmetric_uniform",
                     "--quantize-input", "--fast-mode", "--packed-weights",
                     "--approx-output-dir", str(tmp_path)])
    assert np.isfinite(out["metrics"]["loss"]) and out["result_file"].startswith(str(tmp_path))


# --------------------------------------------------------------------------
# the tiny Llama in w4a8 and in uniform_qc(8)
# --------------------------------------------------------------------------

class UniformJax:
    """The JAX model in one uniform configuration, calibrated as
    ``scripts/bench_llama.py`` does (init, ESTIMATE, a fast
    ``cache_weights`` forward), then packed and stripped."""

    def __init__(self, name, calib):
        self.qc = QCS[name](jc)
        self.spec = JSpec(**SPEC)
        self.model = JLlama(qc=self.qc, spec=self.spec)
        calib = jnp.asarray(calib)
        cache = JCache.zeros(self.spec, calib.shape[0], S)
        est = jsites.ESTIMATE
        self.init = jax.jit(self.model.init, static_argnums=3)(
            jax.random.key(0), calib, cache, est)
        _, ups = jax.jit(lambda v: self.model.apply(
            v, calib, cache, est, mutable=["quant", "quant_est"]))(self.init)
        calibrated = {**self.init, **ups}
        warm = jsites.QuantPhase(phase="fixed", fast=True, cache_weights=True)
        _, ups = jax.jit(lambda v: self.model.apply(
            v, calib, cache, warm, mutable=["quant_cache"]))(calibrated)
        self.cached = {**calibrated, **ups}
        packed, self.report = jfast.pack_dense_caches(self.cached, self.qc)
        self.packed = jfast.strip_packed_params(packed)
        self._apply = {}

    def apply(self, tokens, cache, qp, chunk_attention=False):
        key = (qp, chunk_attention)
        if key not in self._apply:
            self._apply[key] = jax.jit(lambda v, t, c: self.model.apply(
                v, t, c, qp, chunk_attention=chunk_attention))
        logits, cache = self._apply[key](self.packed, jnp.asarray(tokens), cache)
        return np.asarray(logits, np.float32), cache


@pytest.fixture(scope="module", params=["w4a8", "int8"])
def uniform_sides(request):
    """(name, the JAX side, the port's model calibrated by ``calibrate_llama``
    from the bridged JAX init and packed by ``pack_llama``, prompt tokens)."""
    rng = np.random.default_rng(SEED)
    calib = rng.integers(0, SPEC["vocab_size"], size=(2, 12)).astype(np.int32)
    j = UniformJax(request.param, calib)
    model = QuantizedLlama(QCS[request.param](tc), LlamaSpec(**SPEC))
    model.load_state_dict(from_jax_variables(numpy_tree(j.init)), strict=True)
    calibrate_llama(model, calib)
    state = model.state_dict()
    report = pack_llama(model)
    return dict(name=request.param, j=j, model=model, calibrated_state=state, report=report,
                seq=rng.integers(0, SPEC["vocab_size"], size=(2, 16)).astype(np.int64))


def test_calibrate_and_pack_llama_give_the_jax_state(uniform_sides):
    """``calibrate_llama`` gives JAX's site state and f32 weight caches;
    ``pack_llama`` JAX's integer codes for all 15 dense layers, a bit-exact
    report, no f32 kernel left, and a bf16 KV cache."""
    u = uniform_sides
    j, model = u["j"], u["model"]
    expect = from_jax_variables(numpy_tree(
        {k: j.cached[k] for k in ("quant", "quant_est", "quant_cache")}))
    got = u["calibrated_state"]
    assert expect.keys() <= got.keys()
    assert sum(key.endswith("w_q") for key in expect) == 7 * SPEC["num_layers"] + 1
    assert any(key.endswith("delta") for key in expect)
    for key, value in expect.items():
        torch.testing.assert_close(got[key], value, msg=key, **STATE_TOL)
    assert u["report"] == {k.replace("/", "."): v for k, v in j.report.items()}
    assert set(u["report"].values()) == {1.0}
    prefix = "w_i4" if u["name"] == "w4a8" else "w_i8"
    theirs = from_jax_variables(numpy_tree({"quant_cache": j.packed["quant_cache"]}))
    codes = [key for key in theirs if ".w_i" in key]
    assert sum(key.endswith(prefix) for key in codes) == 7 * SPEC["num_layers"] + 1
    ours = model.state_dict()
    assert not any(key.endswith(("kernel", "w_q")) for key in ours)
    for key in codes:
        assert ours[key].dtype == theirs[key].dtype and torch.equal(ours[key], theirs[key]), key
    assert model.packed_kv is False


def _t_cache(batch):
    return KVCache.zeros(LlamaSpec(**SPEC), batch, S, dtype=torch.bfloat16)


def _j_cache(batch):
    return JCache.zeros(JSpec(**SPEC), batch, S, dtype=jnp.bfloat16)


T_PACKED_FUSED = tsites.QuantPhase(phase="fixed", fast=True, packed=True, fused_sdpa=True)
T_CHAINED_FUSED = tsites.QuantPhase(phase="fixed", fast=True, packed=True, chained=True,
                                    fused_sdpa=True)
J_PACKED_FUSED = jsites.QuantPhase(phase="fixed", fast=True, packed=True, fused_sdpa=True)

# a cold chunk (K7), three decode steps (K6) and a warm chunk over the slab
CHUNKS = [(slice(0, 9), True)] + [(slice(i, i + 1), False) for i in (9, 10, 11)] + [
    (slice(12, 16), False)]


def test_packed_logits_through_the_attention_kernels_match_jax(uniform_sides):
    """PACKED with ``fused_sdpa=True`` on a bf16 cache, against JAX's Pallas
    kernels in interpret mode: every step's logits within ``LOGIT_TOL``,
    with no kernel launched on the CPU."""
    u = uniform_sides
    j, model, seq = u["j"], u["model"], u["seq"]
    cache, jcache = _t_cache(2), _j_cache(2)
    before = _launches()
    for cols, chunk_attention in CHUNKS:
        with torch.no_grad():
            logits, cache = model(torch.from_numpy(seq[:, cols]), cache, T_PACKED_FUSED,
                                  chunk_attention=chunk_attention)
        j_logits, jcache = j.apply(seq[:, cols], jcache, J_PACKED_FUSED,
                                   chunk_attention=chunk_attention)
        assert torch.isfinite(logits).all() and logits.shape == j_logits.shape
        np.testing.assert_allclose(logits.numpy(), j_logits, **LOGIT_TOL)
    assert _launches() == before and cache.length.tolist() == [16, 16]


def test_chained_logits_equal_packed(uniform_sides):
    """The port's CHAINED (``Coded`` int8 activations between layers)
    against its PACKED, prefill then decode: bit-equal logits and caches,
    as JAX ``tests/test_chained.py`` holds them."""
    model, seq = uniform_sides["model"], uniform_sides["seq"]
    caches = {}
    for name, qp in (("packed", T_PACKED_FUSED), ("chained", T_CHAINED_FUSED)):
        cache, out = _t_cache(2), []
        with torch.no_grad():
            for cols, chunk_attention in CHUNKS:
                logits, cache = model(torch.from_numpy(seq[:, cols]), cache, qp,
                                      chunk_attention=chunk_attention)
                out.append(logits)
        caches[name] = (cache, out)
    (cp, lp), (cc, lc) = caches["packed"], caches["chained"]
    for a, b in zip(lc, lp):
        assert torch.equal(a, b)
    assert torch.equal(cc.k, cp.k) and torch.equal(cc.v, cp.v)


def test_batcher_tokens_equal_jax(uniform_sides):
    """``ContinuousBatcher`` greedy tokens under PACKED+fused on a bf16
    cache: two prompts in three slots, then a third into a freed slot."""
    u = uniform_sides
    j, model = u["j"], u["model"]

    def serve(batcher):
        slots = [batcher.admit(p, max_new_tokens=n) for p, n in
                 (([1, 2, 3, 4, 5], 6), ([7, 8, 9], 4))]
        batcher.run_to_completion()
        outs = [batcher.retire(s) for s in slots]
        reused = batcher.admit([11, 12], max_new_tokens=3)
        batcher.run_to_completion()
        return outs + [batcher.retire(reused)]

    want = serve(JBatcher(j.model, j.packed, j.spec, slots=3, qp=J_PACKED_FUSED))
    batcher = ContinuousBatcher(model, LlamaSpec(**SPEC), slots=3, qp=T_PACKED_FUSED)
    assert batcher.cache.k.dtype == torch.bfloat16
    assert serve(batcher) == want
