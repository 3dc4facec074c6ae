"""The CNN serving boundary of the port against the JAX package's, on the
CPU: int8 and int4 conv serving (``fastpath.quantized_conv_int8`` under
``PACKED``), the fused ``Affine`` boundary under ``CHAINED`` (int8 and FP8),
the algebra it rests on (``fold_quantize_affine``, ``Affine.then_affine`` /
``with_clamp``, ``quantize_to_fp8_ste_affine``), ViT's uniform
``--packed-weights`` on a tiny ``ViTSpec``, and the ``running_minmax``
estimator.

Both sides calibrate one module from the same init (the JAX variables carry
across through ``models.bridge``), cache and pack their own weights, and the
packed caches (``w_i8`` / ``w_i4`` codes, scale, zero point, code sums) must
be equal. Tolerances:

* layers without BN, and with BN whose ``var + eps`` is a power of four
  (``rsqrt`` exact on both sides: XLA's CPU ``rsqrt`` is not correctly
  rounded elsewhere), the fused boundaries with power-of-two constants,
  ``fold_quantize_affine``, ``quantize_to_fp8_ste_affine`` and
  ``running_minmax``: bit for bit. The integer sums are exact, and every
  other step is the same f32 operation in the same order on both sides.
* whole models (``tests/test_torch_cnn_serving_models.py``): the JAX tests'
  tolerances, ``tests/test_conv_serving.py``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.eval.driver import cache_quantized_weights as j_cache
from fp8_quantization_tpu.numerics.fp8_ste import quantize_to_fp8_ste_affine as j_fp8_affine
from fp8_quantization_tpu.ops import layers as jlayers
from fp8_quantization_tpu.ops.activations import relu6 as j_relu6
from fp8_quantization_tpu.ops.fastpath import pack_dense_caches as j_pack
from fp8_quantization_tpu.ops.fastpath import strip_packed_params as j_strip
from fp8_quantization_tpu.quant import estimators as j_est
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.eval.driver import cache_quantized_weights as t_cache
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.numerics.fp8_ste import quantize_to_fp8_ste_affine as t_fp8_affine
from fp8_quantization_tpu_torch.ops import fastpath
from fp8_quantization_tpu_torch.ops import layers as tlayers
from fp8_quantization_tpu_torch.ops.activations import relu6 as t_relu6
from fp8_quantization_tpu_torch.ops.cuda import KERNELS
from fp8_quantization_tpu_torch.quant import estimators as t_est
from fp8_quantization_tpu_torch.quant import sites as tsites

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

C_IN = 6


def uniform_qc(mod, n_bits=8, res=True, method="symmetric_uniform", n_bits_act=None):
    """``scripts/bench_cnn.py``'s int8 configuration (``int4`` at 4 bits),
    with a res site on every layer where ``res``."""
    return mod.QuantConfig(
        method=mod.QMethod(method), n_bits=n_bits, n_bits_act=n_bits_act,
        per_channel_weights=True, quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        run_method=mod.RunMethodConfig(res_quantizer_flag=res))


def fp8_qc(mod):
    """``scripts/image_net.sh``'s FP8 E3M4 configuration."""
    return mod.QuantConfig(
        method=mod.QMethod.fp_quantizer, per_channel_weights=True, quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True))


def tree(t):
    return jax.tree.map(np.asarray, dict(t))


def power_of_four_var(v, eps=1e-5):
    """BN variances whose f32 ``var + eps`` is a power of four, so that
    ``rsqrt(var + eps)`` is exact in both frameworks."""
    p = 4.0 ** np.clip(np.round(np.log(np.asarray(v) + eps) / np.log(4.0)), -2, 2)
    out = (p.astype(np.float32) - np.float32(eps)).astype(np.float32)
    assert np.all(out + np.float32(eps) == p.astype(np.float32))
    return out


def po2(v, floor=2e-2):
    """Signed powers of two nearest ``v``."""
    v = np.asarray(v)
    return (np.sign(v) * 2.0 ** np.round(np.log2(np.abs(v) + floor))).astype(np.float32)


def calibrated(jm, tm, x, *, edit=None):
    """The JAX module's init, an ESTIMATE forward of ``x`` (calibration on
    that batch), ``edit`` applied to its variables, carried into the port's
    module; returns the JAX variables."""
    variables = tree(jax.jit(lambda k, x: jm.init(k, x, jsites.ESTIMATE))(
        jax.random.key(0), jnp.asarray(x)))
    if edit is not None:
        variables = edit(variables)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    return variables


def packed_pair(jm, tm, x, qc_j, qc_t, *, fast=True, edit=None):
    """Calibrate (:func:`calibrated`), then cache the weights and pack them
    on each side; the packed caches must be equal. Returns the packed and
    stripped JAX variables."""
    variables = calibrated(jm, tm, x, edit=edit)
    jv = j_cache(jm, variables, jnp.asarray(x), fast=fast)
    jv, j_report = j_pack(jv, qc_j)
    jv = j_strip(jv)
    t_cache(tm, x, fast=fast)
    _, t_report = fastpath.pack_dense_caches(tm, qc_t)
    assert t_report == pytest.approx({k.replace("/", "."): v for k, v in j_report.items()})
    assert t_report
    theirs = from_jax_variables(tree({"quant_cache": jv["quant_cache"]}))
    ours = tm.state_dict()
    packed = {k for k in theirs if k.split(".")[-1].startswith(("w_i8", "w_i4", "w_codes",
                                                                 "w_pack_bias"))}
    assert packed and packed == {k for k in ours if k.split(".")[-1].startswith(
        ("w_i8", "w_i4", "w_codes", "w_pack_bias"))}
    for key in packed:
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key].numpy(), theirs[key].numpy(), err_msg=key)
    fastpath.strip_packed_params(tm)
    return jv


def outputs(jm, jv, tm, x, phases=("PACKED", "CHAINED"), jit=False):
    """{phase: (port output, JAX output)}, both decoded to f32 numpy. JAX
    runs op by op unless ``jit``: compiled, XLA fuses a multiply and an add
    (the decode of an ``Affine``, the dequant epilogue) into one rounding,
    which PyTorch's separate operations do not."""
    out = {}
    with torch.no_grad():
        for name in phases:
            fn = lambda v, x, qp=getattr(jsites, name): jsites.decoded(  # noqa: E731
                jm.apply(v, x, qp))
            want = (jax.jit(fn) if jit else fn)(jv, jnp.asarray(x))
            got = tsites.decoded(tm(torch.from_numpy(x), getattr(tsites, name)))
            out[name] = (got.float().numpy(), np.asarray(want, np.float32))
    return out


def launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


LAYER_KW = {
    "plain": dict(features=8, kernel_size=(3, 3)),
    "strided_valid": dict(features=8, kernel_size=(3, 3), strides=(2, 2), padding="VALID"),
    "depthwise": dict(features=C_IN, kernel_size=(3, 3), feature_group_count=C_IN),
    "g2": dict(features=8, kernel_size=(3, 3), feature_group_count=2),
}


def _port_conv(qc, kw):
    kw = dict(kw)
    return tlayers.QuantConv(qc, C_IN, kw.pop("features"), **kw)


@pytest.mark.parametrize("case", list(LAYER_KW), ids=list(LAYER_KW))
def test_int8_conv_matches_jax(case, rng):
    """``tests/test_conv_serving.py``'s four int8 conv layers (with a res
    site): the packed caches, then PACKED (the int8 conv) and CHAINED (the
    result leaves as ``Coded`` codes) against JAX, bit for bit; the stripped
    kernel shows the codes served the conv."""
    kw = LAYER_KW[case]
    x = rng.normal(size=(2, 8, 8, C_IN)).astype(np.float32)
    jm = jlayers.QuantConv(qc=uniform_qc(jc), **kw)
    tm = _port_conv(uniform_qc(tc), kw)
    jv = packed_pair(jm, tm, x, uniform_qc(jc), uniform_qc(tc))
    assert tm.kernel is None and tm.w_i8.shape == (3, 3, C_IN // kw.get("feature_group_count", 1),
                                                    kw["features"])
    before = launches()
    for name, (got, want) in outputs(jm, jv, tm, x).items():
        np.testing.assert_array_equal(got, want, err_msg=name)
    with torch.no_grad():
        assert isinstance(tm(torch.from_numpy(x), tsites.CHAINED), tsites.Coded)
        # a frozen uniform site's grid codes with the dequant pending
        y = torch.from_numpy(x)
        aff = tm.activation_quantizer(y, tsites.FIXED, as_affine=True)
        assert isinstance(aff, tsites.Affine)
        assert torch.equal(tsites.decoded(aff), tm.activation_quantizer(y, tsites.FIXED))
    assert launches() == before                     # no kernel: integer sums


class JTwoConv(fnn.Module):
    """Two stacked BN convs as in ``tests/test_conv_serving.py``; the
    second's act site is fed by the first's activation."""
    qc: jc.QuantConfig
    act: object = fnn.relu
    features: int = 6

    @fnn.compact
    def __call__(self, x, qp):
        y = jlayers.BNQuantConv(qc=self.qc, features=self.features, kernel_size=(3, 3),
                                padding=[(1, 1), (1, 1)], use_bias=False, activation=self.act,
                                name="conv1")(x, qp)
        return jlayers.BNQuantConv(qc=self.qc, features=self.features, kernel_size=(3, 3),
                                   padding=[(1, 1), (1, 1)], use_bias=False,
                                   activation=fnn.relu, name="conv2")(y, qp)


class TTwoConv(torch.nn.Module):
    def __init__(self, qc, act=torch.relu, features=6, in_ch=C_IN):
        super().__init__()
        kw = dict(kernel_size=(3, 3), padding=[(1, 1), (1, 1)], use_bias=False)
        self.conv1 = tlayers.BNQuantConv(qc, in_ch, features, activation=act, **kw)
        self.conv2 = tlayers.BNQuantConv(qc, features, features, activation=torch.relu, **kw)

    def forward(self, x, qp):
        return self.conv2(self.conv1(x, qp), qp)


def exact_bn(variables, *, all_po2=False):
    """BN stats with ``var + eps`` a power of four (and with ``all_po2`` the
    means and gammas powers of two, the betas multiples of 1/8, so that the
    folded BN equals the unfolded one too)."""
    def fix(path, v):
        name = path[-1].key
        if name == "var":
            return power_of_four_var(v)
        if all_po2 and name in ("gamma", "mean"):
            return po2(v)
        if all_po2 and name == "beta":
            return (np.round(v * 8) / 8.0).astype(np.float32)
        return v

    out = dict(variables)
    for coll in ("batch_stats", "params"):
        out[coll] = jax.tree_util.tree_map_with_path(fix, variables[coll])
    return out


SERVING_CASES = {
    # (JAX module, port module, config maker, input channels)
    "bn": (lambda qc: jlayers.BNQuantConv(qc=qc, features=8, kernel_size=(3, 3)),
           lambda qc: tlayers.BNQuantConv(qc, C_IN, 8, kernel_size=(3, 3)),
           uniform_qc),
    "int4": (lambda qc: jlayers.QuantConv(qc=qc, features=8, kernel_size=(3, 3)),
             lambda qc: tlayers.QuantConv(qc, C_IN, 8, kernel_size=(3, 3)),
             lambda mod: uniform_qc(mod, n_bits=4, n_bits_act=8)),
    "asymmetric": (lambda qc: jlayers.QuantConv(qc=qc, features=8, kernel_size=(3, 3)),
                   lambda qc: tlayers.QuantConv(qc, C_IN, 8, kernel_size=(3, 3)),
                   lambda mod: uniform_qc(mod, method="asymmetric_uniform", res=False)),
    "relu_chain": (lambda qc: JTwoConv(qc=qc), lambda qc: TTwoConv(qc), uniform_qc),
}


@pytest.mark.parametrize("case", list(SERVING_CASES), ids=list(SERVING_CASES))
def test_conv_serving_cases_match_jax(case, rng):
    """The BN conv, the int4 conv (nibble-packed ``w_i4``), asymmetric acts
    (``cx`` = -128: padding filled with that code) and two stacked BN convs
    whose second act site calibrates unsigned behind a ReLU, against JAX
    under PACKED and CHAINED (the BN leaves as a pending ``Affine``), bit
    for bit, with BN variances whose ``rsqrt`` is exact."""
    make_j, make_t, make_qc = SERVING_CASES[case]
    x = rng.normal(size=(2, 8, 8, C_IN)).astype(np.float32)
    jm, tm = make_j(make_qc(jc)), make_t(make_qc(tc))
    edit = exact_bn if case in ("bn", "relu_chain") else None
    jv = packed_pair(jm, tm, x, make_qc(jc), make_qc(tc), edit=edit)
    if case == "int4":
        assert tm.w_i4.shape == (27, 8) and tm.w_i8 is None
    if case == "relu_chain":
        assert float(tm.conv2.activation_quantizer.uniform_int_params()[1][0]) == 0
        assert float(tm.conv2.activation_quantizer.uniform_int_params()[2][0]) == 0
    for name, (got, want) in outputs(jm, jv, tm, x).items():
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_fold_quantize_affine_and_compose_match_jax(rng):
    """``fold_quantize_affine`` (with no clamp, ReLU6's and ReLU's, an odd
    zero point) equals the sequential materialize-then-quantize and JAX's
    fold; ``then_affine`` / ``with_clamp`` compose as the stages applied in
    turn, and decode as JAX's; all with power-of-two constants, bit for
    bit."""
    x = rng.integers(-1000, 1000, size=(64, 32)).astype(np.float32)
    scale = (2.0 ** rng.integers(-8, -2, size=32)).astype(np.float32)
    bias = (rng.integers(-64, 64, size=32) * 0.125).astype(np.float32)
    s, zp, lo_i, hi_i = (np.float32(v) for v in (2.0 ** -4, 13.0, 0.0, 255.0))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    for lo, hi in [(None, None), (0.0, 6.0), (0.0, None)]:
        ours = tsites.Affine(t(x), t(scale), t(bias)).with_clamp(lo, hi)
        theirs = jsites.Affine(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)
                               ).with_clamp(lo, hi)
        got = tsites.fold_quantize_affine(ours, t(s), t(zp), t(lo_i), t(hi_i)).numpy()
        v = tsites.decoded(ours).numpy()
        np.testing.assert_array_equal(v, np.asarray(jsites.decoded(theirs)))
        np.testing.assert_array_equal(got, np.clip(np.round(v / s) + zp, lo_i, hi_i))
        np.testing.assert_array_equal(got, np.asarray(jsites.fold_quantize_affine(
            theirs, jnp.asarray(s), jnp.asarray(zp), jnp.asarray(lo_i), jnp.asarray(hi_i))))
    s2 = (2.0 ** rng.integers(-2, 3, size=32)).astype(np.float32)
    b2 = (rng.integers(-8, 8, size=32) * 0.5).astype(np.float32)
    ours = tsites.Affine(t(x), t(scale), t(bias)).then_affine(t(s2), t(b2)).with_clamp(0.0, 6.0)
    got = tsites.decoded(ours).numpy()
    np.testing.assert_array_equal(got, np.clip((x * scale + bias) * s2 + b2, 0.0, 6.0))
    theirs = jsites.Affine(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)).then_affine(
        jnp.asarray(s2), jnp.asarray(b2)).with_clamp(0.0, 6.0)
    np.testing.assert_array_equal(got, np.asarray(jsites.decoded(theirs)))
    assert ours.reshape(8, 8, 32).shape == (8, 8, 32) and ours.dtype == torch.float32
    codes, cx = fastpath.quantize_acts_affine(ours, t(s), t(zp), t(lo_i), t(hi_i))
    assert codes.dtype == torch.int8 and float(cx) == 13.0 - 128.0


@pytest.mark.parametrize("lo,hi", [(None, None), (0.0, 6.0), (0.0, None), (-1.0, 1.0)])
def test_quantize_to_fp8_ste_affine_matches_jax(lo, hi, rng):
    """The FP8 fake-quantize with a pending affine and clamp folded into its
    clip: equal to JAX's, and to the plain quantizer on the materialized
    clamp, bit for bit (E3M4 and E4M3, signed and unsigned grids)."""
    from fp8_quantization_tpu_torch.numerics.fp8_ste import quantize_to_fp8_ste

    x = (rng.normal(size=(4, 5, 16)) * 4).astype(np.float32)
    scale = rng.uniform(0.25, 2.0, size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    for mant, sign in ((4, 1), (3, 1), (4, 0)):
        state = (np.array([5.5], np.float32), np.array([mant], np.float32),
                 np.array([sign], np.int32))
        args = (8, *map(torch.from_numpy, state))
        got, gb = t_fp8_affine(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias), lo, hi, *args)
        want, wb = j_fp8_affine(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                None if lo is None else jnp.float32(lo),
                                None if hi is None else jnp.float32(hi), 8, *state)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        v = tsites.decoded(tsites.Affine(torch.from_numpy(x), torch.from_numpy(scale),
                                         torch.from_numpy(bias), lo, hi))
        plain, _ = quantize_to_fp8_ste(v, *args)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())


def po2_state(variables, *, integer_kernels=False):
    """``tests/test_conv_serving.py``'s power-of-two state: every uniform
    ``delta`` and FP ``maxval`` a power of two, BN as :func:`exact_bn` with
    ``all_po2``; with ``integer_kernels`` the conv kernels small integers,
    so that FP8 conv sums are exact in any order."""
    def fix(path, v):
        name = path[-1].key
        if name == "delta":
            return (2.0 ** np.floor(np.log2(np.abs(v) + 1e-30))).astype(np.float32)
        if name == "maxval":
            return (2.0 ** np.ceil(np.log2(np.abs(v) + 1e-30))).astype(np.float32)
        if integer_kernels and name == "kernel":
            return np.clip(np.round(v * 2), -2, 2).astype(np.float32)
        return v

    out = exact_bn(variables, all_po2=True)
    for coll in ("quant", "params"):
        out[coll] = jax.tree_util.tree_map_with_path(fix, out[coll])
    return out


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_fused_boundary_exact_po2(kind, rng):
    """Two stacked BN convs (ReLU6, then ReLU) with power-of-two state: the
    fused boundary (CHAINED: BN leaves as a pending ``Affine``, the clamp
    sets its bounds, the next act site folds it into its integer clip or its
    FP8 clip) equals the unfused PACKED path, and both equal JAX's, bit for
    bit."""
    qc = uniform_qc if kind == "int8" else fp8_qc
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    if kind == "fp8":
        x = np.round(x * 2)  # small integers: exact FP8 conv sums
    jm = JTwoConv(qc=qc(jc), act=j_relu6, features=8)
    tm = TTwoConv(qc(tc), act=t_relu6, features=8, in_ch=8)
    edit = lambda v: po2_state(v, integer_kernels=kind == "fp8")  # noqa: E731
    jv = packed_pair(jm, tm, x, qc(jc), qc(tc), fast=False, edit=edit)
    out = outputs(jm, jv, tm, x)
    np.testing.assert_array_equal(out["CHAINED"][0], out["PACKED"][0])
    for name, (got, want) in out.items():
        np.testing.assert_array_equal(got, want, err_msg=name)
    with torch.no_grad():
        y = tm.conv1(torch.from_numpy(x), tsites.CHAINED)
    assert isinstance(y, tsites.Affine) and (y.lo, y.hi) == (0.0, 6.0)
    assert y.x.dtype == (torch.float32 if kind == "int8" else torch.bfloat16)


def test_running_minmax_matches_jax(rng):
    """``running_minmax``: the first batch's range, then the moving average
    with ``momentum`` on the state, per tensor and per channel, over three
    batches, bit for bit with JAX."""
    qcfg = (uniform_qc(jc).act_quantizer(), uniform_qc(tc).act_quantizer())
    for per_channel, momentum in ((False, 0.9), (True, 0.7)):
        jcfg = jc.EstimatorConfig(jc.RangeMethod.running_minmax, momentum=momentum)
        tcfg = tc.EstimatorConfig(tc.RangeMethod.running_minmax, momentum=momentum)
        shape = (4, 5, 3)
        c = shape[-1] if per_channel else 1
        js = j_est.init(jcfg, qcfg[0], shape, per_channel, -1)
        ts = t_est.init(tcfg, qcfg[1], c)
        for _ in range(3):
            x = (rng.normal(size=shape) * rng.uniform(0.5, 3)).astype(np.float32)
            js, jr = j_est.update(jcfg, qcfg[0], js, jnp.asarray(x), per_channel, -1)
            ts, tr = t_est.update(tcfg, qcfg[1], ts, torch.from_numpy(x), per_channel, -1)
            for key in ("xmin", "xmax", "count"):
                np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]), err_msg=key)
            for a, b in zip(tr[:2], jr[:2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(ts["count"]) == 3


def test_vit_uniform_packed_weights_match_jax(rng):
    """Configuration D on a tiny ``ViTSpec``: the int8 flags of
    ``scripts/bench_cnn.py`` (no res sites), the patch embedding an int8
    conv (``w_i8``; under CHAINED its result leaves as an ``Affine`` and the
    patch site folds it into ``Coded`` codes), every dense layer int8. The
    packed caches equal JAX's; PACKED and CHAINED logits within the int8
    tolerance of ``tests/test_conv_serving.py`` (5e-4) of JAX's with the
    same top-1 (LayerNorm and GELU round differently in the two frameworks),
    and CHAINED equal to PACKED (the patch conv's fold has no BN)."""
    from fp8_quantization_tpu.models.vit import QuantizedViT as JViT
    from fp8_quantization_tpu.models.vit import ViTSpec as JSpec
    from fp8_quantization_tpu_torch.models.vit import QuantizedViT as TViT
    from fp8_quantization_tpu_torch.models.vit import ViTSpec as TSpec

    tiny = dict(hidden_size=32, num_layers=2, num_heads=4, mlp_dim=64, patch_size=8,
                image_size=32, num_classes=10)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = JViT(qc=uniform_qc(jc, res=False), spec=JSpec(**tiny))
    tm = TViT(uniform_qc(tc, res=False), TSpec(**tiny))
    jv = packed_pair(jm, tm, x, uniform_qc(jc, res=False), uniform_qc(tc, res=False),
                     fast=False)
    assert tm.patch_projection.w_i8.shape == (8, 8, 3, 32)
    before = launches()
    out = outputs(jm, jv, tm, x, jit=True)
    assert launches() == before
    np.testing.assert_array_equal(out["CHAINED"][0], out["PACKED"][0])
    for name, (got, want) in out.items():
        assert np.isfinite(got).all() and got.shape == (2, 10)
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4, err_msg=name)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=name)
