"""The port's serving modes against the JAX package's, on the CPU: the bf16
fast mode (``FAST``), packed-FP8 weights through the dequant GEMM
(``PACKED``) and 1-byte activation codes between layers (``CHAINED``).

* ``CodedFP`` codes and packing bias of a calibrated site: bit-exact.
* The weight cache and its packed codes (``quant_cache`` in JAX, the layers'
  cache buffers here): bit-exact.
* ``QuantDense`` and the tiny ViT of ``tests/test_torch_vit.py`` (its spec,
  its seed and its ``LOGIT_TOL``, ``rtol=atol=1e-5``, for the reasons its
  docstring gives), loaded through ``models.bridge`` from the JAX
  variables: outputs within ``LOGIT_TOL`` and the same top-1.

On the CPU every kernel wrapper takes its plain version; the launch counters
must not move.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.eval.driver import cache_quantized_weights as j_cache
from fp8_quantization_tpu.eval.driver import calibrate as j_calibrate
from fp8_quantization_tpu.models.vit import QuantizedViT as JViT
from fp8_quantization_tpu.models.vit import ViTSpec as JSpec
from fp8_quantization_tpu.ops.fastpath import pack_dense_caches as j_pack_caches
from fp8_quantization_tpu.ops.layers import QuantDense as JDense
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import cli as tcli
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.eval.driver import cache_quantized_weights as t_cache
from fp8_quantization_tpu_torch.eval.driver import calibrate as t_calibrate
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.vit import QuantizedViT as TViT
from fp8_quantization_tpu_torch.models.vit import ViTSpec as TSpec
from fp8_quantization_tpu_torch.ops import fastpath
from fp8_quantization_tpu_torch.ops.cuda import approx_matmul as k3
from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as k4
from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as k2
from fp8_quantization_tpu_torch.ops.layers import QuantConv as TConv
from fp8_quantization_tpu_torch.ops.layers import QuantDense as TDense
from fp8_quantization_tpu_torch.quant import sites as tsites
from test_torch_vit import LOGIT_TOL, SEED, TINY, _jax_init, _numpy_tree, _qc

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

MODES = ["fast", "packed", "chained"]
J_PHASE = {"fast": jsites.FAST, "packed": jsites.PACKED, "chained": jsites.CHAINED}
T_PHASE = {"fast": tsites.FAST, "packed": tsites.PACKED, "chained": tsites.CHAINED}


def _launches():
    return (k2.quantize_block.launches, k2.fused_quant_matmul.launches,
            k3.approx_matmul.launches, k4.dequant_matmul.launches)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _values(y):
    """Output of a layer or model as f32 numpy, decoding chained codes."""
    if isinstance(y, jsites.CodedFP):
        y = jsites.decoded(y)
    if isinstance(y, tsites.CodedFP):
        y = tsites.decoded(y)
    return y.detach().to(torch.float32).numpy() if isinstance(y, torch.Tensor) else _f32(y)


@pytest.mark.parametrize("maxval", [1.0, 1.5], ids=["repacks_on_bias_minus_1", "fits"])
def test_codedfp_codes_match_jax(maxval, rng):
    """A calibrated per-tensor site's chained codes and packing bias equal
    JAX's bit for bit. At maxval 1.0 the rounded STE bias puts the top
    binade past the 3-bit field, so the codes repack on bias - 1; at 1.5
    the grid fits and the codes decode to the fake-quantized values."""
    qc = _qc(jc, False)
    x = rng.normal(size=(6, 20)).astype(np.float32)
    x *= maxval / np.abs(x).max()
    jsite = jsites.QuantSite(qc.act_quantizer(), qc.act_range)
    v = jsite.init(jax.random.key(0), jnp.asarray(x), jsites.ESTIMATE)
    _, ups = jsite.apply(v, jnp.asarray(x), jsites.ESTIMATE, mutable=["quant", "quant_est"])
    v = {**v, **ups}
    j_codes = jsite.apply(v, jnp.asarray(x), jsites.CHAINED, as_codes=True)
    j_fake = jsite.apply(v, jnp.asarray(x), jsites.FIXED)

    tqc = _qc(tc, False)
    tsite = tsites.QuantSite(tqc.act_quantizer(), tqc.act_range)
    tsite(torch.from_numpy(x), tsites.ESTIMATE)
    t_codes = tsite(torch.from_numpy(x), tsites.CHAINED, as_codes=True)
    assert isinstance(t_codes, tsites.CodedFP) and t_codes.codes.dtype == torch.uint8
    np.testing.assert_array_equal(t_codes.codes.numpy(), np.asarray(j_codes.codes))
    assert int(t_codes.bias) == int(j_codes.bias)
    assert (t_codes.expo_width, t_codes.mant_width) == (j_codes.expo_width, j_codes.mant_width)
    ste_bias = int(tsite.fp_bias()[0])
    assert (int(t_codes.bias) == ste_bias) == (maxval == 1.5)
    if maxval == 1.5:
        np.testing.assert_array_equal(_values(t_codes), _f32(j_fake))
    # the fast phase's K1 route equals the fixed phase's STE quantizer
    np.testing.assert_array_equal(_values(tsite(torch.from_numpy(x), tsites.FAST)),
                                  _values(tsite(torch.from_numpy(x), tsites.FIXED)))


def test_quant_dense_serving_matches_jax(rng):
    """One calibrated QuantDense, its weights cached and packed: FAST,
    PACKED and CHAINED outputs against JAX's, the packed codes bit-exact."""
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    jqc, tqc = _qc(jc, False), _qc(tc, False)
    jl = JDense(qc=jqc, features=24)
    v = jl.init(jax.random.key(1), jnp.asarray(x), jsites.ESTIMATE)
    _, ups = jl.apply(v, jnp.asarray(x), jsites.ESTIMATE, mutable=["quant", "quant_est"])
    v = {**v, **ups}
    cache_qp = jsites.QuantPhase(phase="fixed", cache_weights=True, fast=True)
    _, ups = jl.apply(v, jnp.asarray(x), cache_qp, mutable=["quant_cache"])
    vp, report = j_pack_caches({**v, **ups}, jqc)

    tl = TDense(tqc, 32, 24)
    tl.load_state_dict(from_jax_variables(_numpy_tree(
        {k: v[k] for k in ("params", "quant", "quant_est")})), strict=True)
    tl(torch.from_numpy(x), tsites.QuantPhase(phase="fixed", cache_weights=True, fast=True))
    _, t_report = fastpath.pack_dense_caches(tl, tqc)
    assert t_report == {"": report[""]}
    for key, value in from_jax_variables(_numpy_tree({"quant_cache": vp["quant_cache"]})).items():
        ours = tl.state_dict()[key]
        assert ours.dtype == value.dtype, key
        np.testing.assert_array_equal(ours.to(torch.float32).numpy(),
                                      value.to(torch.float32).numpy(), err_msg=key)
    before = _launches()
    for mode in MODES:
        theirs = jl.apply(vp, jnp.asarray(x), J_PHASE[mode])
        ours = tl(torch.from_numpy(x), T_PHASE[mode])
        assert isinstance(ours, tsites.CodedFP) == (mode == "chained")
        np.testing.assert_allclose(_values(ours), _values(theirs), **LOGIT_TOL, err_msg=mode)
    assert _launches() == before


@functools.lru_cache(maxsize=None)
def _jax_serving_state():
    """The tiny JAX ViT calibrated on one batch, its weights cached (fast)
    and packed, and the inputs: (model, variables, calib, x)."""
    rng = np.random.default_rng(SEED)
    calib, x = (rng.normal(size=(2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    jm = JViT(qc=_qc(jc, False), spec=JSpec(**TINY))
    calibrated = j_calibrate(jm, _jax_init(), [calib], num_est_batches=1)
    cached = j_cache(jm, calibrated, jnp.zeros((1, 32, 32, 3)), fast=True)
    packed, _ = j_pack_caches(cached, jm.qc)
    return jm, packed, calib, x


def _port_serving_model(calib):
    tm = TViT(qc=_qc(tc, False), spec=TSpec(**TINY))
    tm.load_state_dict(from_jax_variables(_numpy_tree(_jax_init())), strict=True)
    t_calibrate(tm, [calib], num_est_batches=1)
    t_cache(tm, torch.zeros(1, 32, 32, 3), fast=True)
    fastpath.pack_dense_caches(tm, tm.qc)
    return tm


@pytest.mark.parametrize("mode", MODES)
def test_tiny_vit_serving_matches_jax(mode):
    """Calibrate, cache and pack both models, then evaluate one batch in the
    serving mode; the cache and codes are bit-exact, the logits within
    ``LOGIT_TOL`` with the same top-1."""
    jm, jv, calib, x = _jax_serving_state()
    j_logits = _f32(jax.jit(lambda v, x: jm.apply(v, x, J_PHASE[mode]))(jv, jnp.asarray(x)))
    tm = _port_serving_model(calib)
    before = _launches()
    with torch.no_grad():
        t_logits = _values(tm(torch.from_numpy(x), T_PHASE[mode]))
    assert _launches() == before      # CPU tensors: plain versions
    expect = from_jax_variables(_numpy_tree({"quant_cache": jv["quant_cache"]}))
    got = tm.state_dict()
    assert len(expect) == 14 * 5      # 13 dense layers and the patch conv
    for key, value in expect.items():
        np.testing.assert_array_equal(got[key].to(torch.float32).numpy(),
                                      value.to(torch.float32).numpy(), err_msg=key)
    assert np.isfinite(t_logits).all() and t_logits.shape == (2, 10)
    np.testing.assert_allclose(t_logits, j_logits, **LOGIT_TOL)
    np.testing.assert_array_equal(t_logits.argmax(-1), j_logits.argmax(-1))


def test_stripped_model_serves_the_same():
    """``strip_packed_params`` drops the f32 kernels and bf16 caches of
    packed layers; the packed phases never read them."""
    _, _, calib, x = _jax_serving_state()
    tm = _port_serving_model(calib)
    with torch.no_grad():
        full = {m: _values(tm(torch.from_numpy(x), T_PHASE[m])) for m in ("packed", "chained")}
        fastpath.strip_packed_params(tm)
        assert tm.classifier.kernel is None and tm.classifier.w_q is None
        assert tm.classifier.w_codes.dtype == torch.uint8
        for m, logits in full.items():
            np.testing.assert_array_equal(_values(tm(torch.from_numpy(x), T_PHASE[m])), logits)


FLAG_SETS = [["--fast-mode"], ["--fast-mode", "--packed-weights"],
             ["--fast-mode", "--packed-weights", "--chained-acts"]]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "+".join(s[2:] for s in f))
def test_cli_serving_flags_on_cpu(flags, tmp_path, monkeypatch):
    """``validate-quantized`` with the reference's flag set and the serving
    flags, at the tiny spec on the CPU: calibrate, cache, pack, evaluate,
    write the result file; no kernel launches."""
    monkeypatch.setattr(tcli, "build_model",
                        functools.partial(tcli.build_model, spec=TSpec(**TINY)))
    argv = ["validate-quantized", "--architecture", "vit_quantized", "--synthetic-data",
            "--no-cuda", "--batch-size", "2", "--max-eval-batches", "1", "--n-bits", "8",
            "--qmethod", "fp_quantizer", "--per-channel", "--fp8-mantissa-bits", "4",
            "--fp8-set-maxval", "--no-fp8-mse-include-mantissa-bits",
            "--weight-quant-method", "current_minmax", "--act-quant-method", "allminmax",
            "--quantize-input", "--res-quantizer-flag", "--original-quantize-res",
            "--approx-output-dir", str(tmp_path)] + flags
    before = _launches()
    out = tcli.main(argv)
    assert _launches() == before
    assert out["device"] == "cpu" and out["images"] == 4
    assert np.isfinite(out["metrics"]["loss"])
    with open(out["result_file"]) as f:
        assert "final_metrics" in f.read()


def test_serving_flags_with_cuda_and_no_gpu_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tcli.build_parser().parse_args(
        ["validate-quantized", "--architecture", "vit_quantized", "--synthetic-data",
         "--fast-mode", "--packed-weights", "--chained-acts"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.run_validate(args)


def test_later_slices_raise():
    """LSQ gradient scaling, which raised until QAT was ported, now rides
    a phase. Fused CNN boundaries and the int8 codes
    of a uniform conv, which raised until the CNN serving boundary was
    ported, now work: a pending ``Affine`` decodes, and packing such a conv
    gives kernel-shaped ``w_i8`` codes."""
    aff = tsites.Affine(torch.tensor([1.0, -3.0]), torch.tensor(2.0), torch.tensor(0.5))
    assert torch.equal(tsites.decoded(aff.with_clamp(0.0, None)), torch.tensor([2.5, 0.0]))
    uniform = tc.QuantConfig(method=tc.QMethod.symmetric_uniform, quantize_input=True,
                             weight_range=tc.EstimatorConfig(tc.RangeMethod.current_minmax),
                             act_range=tc.EstimatorConfig(tc.RangeMethod.allminmax))
    conv = TConv(uniform, 2, 2, kernel_size=(1, 1))
    conv.w_q = torch.zeros((1, 1, 2, 2))
    _, report = fastpath.pack_dense_caches(conv, uniform)
    assert report == {"": 1.0} and conv.w_i8.shape == (1, 1, 2, 2)
    lsq = dataclasses.replace(tsites.FIXED, grad_scaling=True)
    assert lsq.grad_scaling and not lsq.estimating
    # BN re-estimation is ported (the CNN slice)
    assert dataclasses.replace(tsites.FIXED, reestimate_bn=True).reestimate_bn
    site = tsites.QuantSite(_qc(tc, False).act_quantizer(), _qc(tc, False).act_range)
    with pytest.raises(ValueError, match="as_codes"):
        site(torch.ones(3), tsites.PACKED, as_codes=True)   # not a chained phase
