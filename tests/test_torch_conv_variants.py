"""The conv kinds and layers of the surgery path against the JAX package's,
on the CPU: ``QuantConv1d``, ``QuantConvTranspose`` and
``QuantConvTranspose1d`` (SAME / VALID, strides 1-2, kernel dilation, torch's
explicit padding and output padding), ``QuantConv`` and
``QuantConvTranspose`` of spatial rank 3, ``BNQuantDense`` and the tied and
untied ``QuantizedActWrapper``.

Each layer runs every method and mode of the port's 2-D ``QuantConv``, as
cases of one test: ESTIMATE (the site state), FIXED, approx (K3's plain
version here, JAX's Pallas kernel in interpret mode), quantize-after-mult-
and-add, FAST, PACKED, FP8
CHAINED, and int8 PACKED and CHAINED (unsigned acts: the holes of the input
dilation and the padding hold the zero point's code). Tolerance: bit for bit,
as ``tests/test_conv_serving.py`` and ``tests/test_torch_cnn_layers.py``
claim at these values. The operands are small integers (in the uniform
cases, integers on unit grids: acts 0..255, weights -127..127) and every sum
of their grid values is exact in f32 in any order; BN's ``var + eps`` is a power of four, so its ``rsqrt`` is exact
in both frameworks. JAX runs op by op: compiled, XLA fuses a multiply and an
add into one rounding.

The pure-math checks hold the transposed conv with its ported torch kernel
and padding to ``F.conv_transpose1d/2d`` (``tests/test_conv_variants.py``'s
``rtol=atol=1e-4``) and the input-dilated im2col to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.eval.driver import cache_quantized_weights as j_cache
from fp8_quantization_tpu.ops import layers as jlayers
from fp8_quantization_tpu.ops.fastpath import pack_dense_caches as j_pack
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.eval.driver import cache_quantized_weights as t_cache
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.models.porting import (conv_transpose_kernel,
                                                       conv_transpose_padding_from_torch)
from fp8_quantization_tpu_torch.ops import fastpath
from fp8_quantization_tpu_torch.ops import layers as tlayers
from fp8_quantization_tpu_torch.quant import sites as tsites

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

C_IN, C_OUT = 3, 4


def _qc(mod, family):
    """``scripts/image_net.sh``'s FP8 E3M4 flags (``fp8``), with the approx
    run method (``approx``) or quantize-after-mult-and-add (``qama``), or
    ``scripts/bench_cnn.py``'s int8 ones with a res site (``int8``)."""
    est = dict(weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
               act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax))
    if family == "int8":
        return mod.QuantConfig(method=mod.QMethod.symmetric_uniform, per_channel_weights=True,
                               quantize_input=True, run_method=mod.RunMethodConfig(
                                   res_quantizer_flag=True), **est)
    approx = family == "approx"
    return mod.QuantConfig(
        method=mod.QMethod.fp_quantizer, per_channel_weights=True, quantize_input=True,
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True,
                                       approx_flag=approx,
                                       quantize_after_mult_and_add=family == "qama"),
        approx=mod.ApproxConfig(with_comp=approx, with_approx=approx), **est)


# (layer class, layer kwargs, one input's shape)
KINDS = {
    "conv1d": ("QuantConv1d", dict(kernel_size=(3,), strides=(2,), padding=[(1, 1)]), (9, C_IN)),
    "convT2d_same_s2": ("QuantConvTranspose", dict(kernel_size=(3, 3), strides=(2, 2),
                                                   padding="SAME"), (4, 3, C_IN)),
    "convT2d_valid_s1_dilated": ("QuantConvTranspose", dict(
        kernel_size=(2, 2), strides=(1, 1), padding="VALID", kernel_dilation=(2, 2)),
        (4, 3, C_IN)),
    # torch's padding 1 and output padding 1 at stride 2
    "convT1d_torch_s2": ("QuantConvTranspose1d", dict(
        kernel_size=(4,), strides=(2,), padding=conv_transpose_padding_from_torch((4,), 2, 1, 1)),
        (5, C_IN)),
    "bnlinear": ("BNQuantDense", dict(use_bias=False), (C_IN,)),
    # spatial rank 3 (JAX's any-rank layers): a strided SAME conv and a
    # stride-2 transposed conv
    "conv3d": ("QuantConv", dict(kernel_size=(3, 3, 3), strides=(1, 2, 1), padding="SAME"),
               (3, 4, 3, C_IN)),
    "convT3d_same_s2": ("QuantConvTranspose", dict(kernel_size=(2, 2, 2), strides=(2, 2, 2),
                                                   padding="SAME"), (2, 3, 2, C_IN)),
}
# the phases each family holds after ESTIMATE
FAMILIES = {"fp8": ("FIXED", "FAST", "PACKED", "CHAINED"), "approx": ("FIXED",),
            "qama": ("FIXED",), "int8": ("PACKED", "CHAINED")}
CASES = ([(k, "fp8") for k in KINDS]
         + [(k, "approx") for k in ("conv1d", "convT2d_same_s2", "bnlinear", "conv3d",
                                    "convT3d_same_s2")]
         + [(k, "qama") for k in ("conv1d", "convT2d_same_s2", "conv3d")]
         + [(k, "int8") for k in ("conv1d", "convT2d_same_s2", "convT1d_torch_s2", "bnlinear",
                                  "conv3d", "convT3d_same_s2")])


def _tree(t):
    return jax.tree.map(np.asarray, dict(t))


def _pair(kind, family, rng):
    """The JAX layer, its variables calibrated on one batch, the port's
    layer carrying them, and an eval batch. Kernel and bias are small
    integers (the bias, where there is one, is on the FP8 grid), BN's
    ``var + eps`` a power of four; in the uniform family the acts are
    integers in 0..255 and the kernel in -127..127, both reaching the top of
    their range, so both grids have a unit step."""
    name, kw, shape = KINDS[kind]
    uniform = family == "int8"
    calib, x = (rng.integers(0, 256, size=(2, *shape)) if uniform
                else rng.integers(-3, 4, size=(2, *shape)) for _ in range(2))
    if uniform:
        # unsigned acts on a unit grid: each batch reaches 255
        calib.reshape(-1)[0] = x.reshape(-1)[0] = 255
    calib, x = calib.astype(np.float32), x.astype(np.float32)
    jm = getattr(jlayers, name)(qc=_qc(jc, family), features=C_OUT, **kw)
    tm = getattr(tlayers, name)(_qc(tc, family), C_IN, C_OUT, **kw)
    # the port's fresh layer; flax creates the site state in the first
    # ESTIMATE apply, from the same initial values
    kshape = tuple(tm.kernel.shape)
    kernel = rng.integers(-127, 128, size=kshape) if uniform else rng.integers(-2, 3, size=kshape)
    if uniform:
        # per-channel weights on a unit grid: each channel reaches 127
        kernel.reshape(-1, C_OUT)[0] = 127
    params = {"kernel": kernel.astype(np.float32)}
    variables = {"params": params}
    if tm.bias is not None:
        params["bias"] = rng.integers(-2, 3, size=C_OUT).astype(np.float32)
    if isinstance(tm, tlayers.BNQuantDense):
        params["gamma"] = rng.choice([0.5, 1.0, 2.0], size=C_OUT).astype(np.float32)
        params["beta"] = rng.integers(-2, 3, size=C_OUT).astype(np.float32)
        variables["batch_stats"] = {
            "mean": rng.integers(-2, 3, size=C_OUT).astype(np.float32),
            "var": (np.float32(4.0) ** rng.integers(-1, 2, size=C_OUT).astype(np.float32)
                    - np.float32(1e-5)).astype(np.float32)}
    missing, unexpected = tm.load_state_dict(from_jax_variables(variables), strict=False)
    assert not unexpected and all("quantizer" in k for k in missing)
    # calibration from the integer kernel on both sides: equal site state
    _, ups = jm.apply(variables, jnp.asarray(calib), jsites.ESTIMATE,
                      mutable=["quant", "quant_est"])
    variables = {**variables, **_tree(ups)}
    with torch.no_grad():
        tm(torch.from_numpy(calib), tsites.ESTIMATE)
    got = tm.state_dict()
    want = from_jax_variables({k: variables[k] for k in ("quant", "quant_est")})
    assert set(want) == set(missing)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)
    return jm, variables, tm, x


def _outputs(jm, jv, tm, x, phase):
    want = np.asarray(jsites.decoded(jm.apply(jv, jnp.asarray(x), getattr(jsites, phase))),
                      np.float32)
    with torch.no_grad():
        got = tsites.decoded(tm(torch.from_numpy(x), getattr(tsites, phase))).float().numpy()
    return got, want


@pytest.mark.parametrize("kind,family", CASES, ids=[f"{k}-{f}" for k, f in CASES])
def test_layer_matches_jax(kind, family, rng):
    """ESTIMATE's site state, then each phase of ``FAMILIES[family]``, bit
    for bit against JAX; the serving phases after both sides cached (bf16)
    and packed their weights, with equal packed codes."""
    jm, jv, tm, x = _pair(kind, family, rng)
    phases = FAMILIES[family]
    if phases[0] == "FIXED":
        got, want = _outputs(jm, jv, tm, x, "FIXED")
        np.testing.assert_array_equal(got, want, err_msg="FIXED")
        assert np.abs(want).max() > 0
    if len(phases) == 1:
        return
    jv = j_cache(jm, jv, jnp.asarray(x), fast=True)
    t_cache(tm, x, fast=True)
    if "FAST" in phases:
        got, want = _outputs(jm, jv, tm, x, "FAST")
        np.testing.assert_array_equal(got, want, err_msg="FAST")
    jv, j_report = j_pack(jv, _qc(jc, family))
    _, t_report = fastpath.pack_dense_caches(tm, _qc(tc, family))
    assert t_report == pytest.approx(dict(j_report)) and t_report
    theirs = from_jax_variables(_tree({"quant_cache": jv["quant_cache"]}))
    ours = tm.state_dict()
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype and torch.equal(ours[key], theirs[key]), key
    codes = "w_codes" if family == "fp8" else "w_i8"
    assert getattr(tm, codes) is not None
    for phase in phases[phases.index("PACKED"):]:
        got, want = _outputs(jm, jv, tm, x, phase)
        np.testing.assert_array_equal(got, want, err_msg=phase)


def _pool(mod):
    if mod is jnp:
        return lambda x: jax.lax.reduce_window(x, 0.0, jax.lax.add, (1, 2, 2, 1),
                                               (1, 2, 2, 1), "VALID") * 0.25
    return lambda x: torch.nn.functional.avg_pool2d(
        x.movedim(-1, 1), 2, stride=2).movedim(1, -1)


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "untied"])
def test_act_wrapper_matches_jax(tie, rng):
    """A 2x2 average pool in ``QuantizedActWrapper``: ESTIMATE's site state
    (tied: the site sees the input and the output) and the FIXED output bit
    for bit (the quarter-sums of grid values are exact)."""
    qc_j, qc_t = _qc(jc, "fp8"), _qc(tc, "fp8")
    calib, x = (rng.integers(-3, 4, size=(2, 4, 4, C_IN)).astype(np.float32) for _ in range(2))
    jm = jlayers.QuantizedActWrapper(qc=qc_j, op=_pool(jnp), tie_input_output=tie)
    tm = tlayers.QuantizedActWrapper(qc_t, _pool(torch), tie_input_output=tie)
    variables = _tree(jm.init(jax.random.key(0), jnp.asarray(calib), jsites.ESTIMATE))
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    _, ups = jm.apply(variables, jnp.asarray(x), jsites.ESTIMATE, mutable=["quant", "quant_est"])
    variables = {**variables, **_tree(ups)}
    with torch.no_grad():
        tm(torch.from_numpy(x), tsites.ESTIMATE)
    want = from_jax_variables({k: variables[k] for k in ("quant", "quant_est")})
    got = tm.state_dict()
    assert set(want) == set(got)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)
    got, want = _outputs(jm, variables, tm, calib, "FIXED")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 2, 2, C_IN)


@pytest.mark.parametrize("k,s,p,op,d", [((3, 3), 2, 1, 1, 1), ((4, 4), 2, 1, 0, 1),
                                        ((3, 3), 1, 0, 0, 1), ((3, 3), 2, 1, 0, 2),
                                        ((5,), 3, 3, 2, 1)])
def test_conv_transpose_matches_torch(rng, k, s, p, op, d):
    """A torch ``ConvTranspose`` weight and padding, ported
    (``conv_transpose_kernel``, ``conv_transpose_padding_from_torch``: the
    last case's padding is negative on one side), reproduce
    ``F.conv_transpose1d/2d`` with quantization off."""
    n = len(k)
    x = rng.normal(size=(2, 4, *(7,) * n)).astype(np.float32)
    w = rng.normal(size=(4, 6, *k)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    conv = (torch.nn.functional.conv_transpose1d, torch.nn.functional.conv_transpose2d)[n - 1]
    ref = conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), stride=s,
               padding=p, output_padding=op, dilation=d).movedim(1, -1)
    layer = tlayers.QuantConvTranspose(tc.QuantConfig(), 4, 6, kernel_size=k, strides=(s,) * n,
                                       padding=conv_transpose_padding_from_torch(k, s, p, op, d),
                                       kernel_dilation=(d,) * n)
    with torch.no_grad():
        layer.kernel.copy_(conv_transpose_kernel(torch.from_numpy(w)))
        layer.bias.copy_(torch.from_numpy(b))
        y = layer(torch.from_numpy(x).movedim(1, -1),
                  tsites.QuantPhase(phase="fixed", quant_w=False, quant_a=False))
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,kernel,pads,ld", [
    ((2, 6, 6, 3), (3, 3, 3, 5), ((2, 2), (2, 2)), (2, 2)),
    ((2, 5, 3), (4, 3, 5), ((3, 1),), (3,)),
    ((2, 5, 4, 3), (3, 2, 3, 5), ((-1, 2), (1, 0)), (2, 1))])
def test_patches_with_input_dilation_match_jax(rng, shape, kernel, pads, ld):
    """The input-dilated im2col (the transposed conv's special paths and its
    int8 sums) equals JAX's, negative padding included."""
    x = rng.normal(size=shape).astype(np.float32)
    n = len(ld)
    want = np.asarray(jlayers.conv_patches(jnp.asarray(x), kernel, (1,) * n, pads, (1,) * n,
                                           input_dilation=ld))
    got = tlayers.conv_patches(torch.from_numpy(x), kernel, (1,) * n, pads, (1,) * n,
                               input_dilation=ld)
    np.testing.assert_array_equal(got.numpy(), want)
