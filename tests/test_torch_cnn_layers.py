"""The CNN layers of the port against the JAX package's, on the CPU: grouped
and depthwise ``QuantConv``, its approximate-multiplier paths, the oracle of
the grouped ones, and ``BNQuantConv`` with BN re-estimation.

Tolerances:

* ``QuantConv`` (g = 1, 2 and depthwise) in every phase, with and without
  the approximate multiplier, and the grouped oracle: bit for bit. The
  operands are small integers or grid values whose products and sums are
  exact in f32 in any order, so the two frameworks' summation orders
  cannot differ.
* ``BNQuantConv``: the BN outputs and re-estimated stats within
  ``rtol=atol=1e-6``. Every BN layer computes ``rsqrt(var + eps)``, which
  XLA's CPU ``rsqrt`` does not round correctly, and the batch mean and
  variance sum in another order; the conv results feeding them are equal.

The g = 1 approx conv runs K3's plain version here and the Pallas kernel
(interpret mode) in JAX; the grouped ones the jnp oracle (``jax.vmap`` over
groups) in JAX and ``layers.approx_matmul_oracle`` here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.eval.driver import cache_quantized_weights as j_cache
from fp8_quantization_tpu.eval.driver import reestimate_bn as j_reestimate
from fp8_quantization_tpu.ops import layers as jlayers
from fp8_quantization_tpu.ops.fastpath import pack_dense_caches as j_pack
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.eval.driver import cache_quantized_weights as t_cache
from fp8_quantization_tpu_torch.eval.driver import reestimate_bn as t_reestimate
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.numerics.approx_matmul import approx_matmul_golden
from fp8_quantization_tpu_torch.numerics.codec import value_space
from fp8_quantization_tpu_torch.numerics.luts import get_error_table
from fp8_quantization_tpu_torch.ops import layers as tlayers
from fp8_quantization_tpu_torch.ops.cuda import KERNELS
from fp8_quantization_tpu_torch.ops.fastpath import pack_dense_caches as t_pack
from fp8_quantization_tpu_torch.quant import sites as tsites

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

C_IN, C_OUT = 4, 8


def _qc(mod, approx=False, expo=3, mant=4, s2nn2s=False, qama=False):
    """``scripts/image_net.sh``'s configuration at E{expo}M{mant}, plus the
    approx or the quantize-after-mult-and-add run method."""
    return mod.QuantConfig(
        method=mod.QMethod.fp_quantizer, per_channel_weights=True, quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False,
                          mantissa_bits=mant),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True,
                                       approx_flag=approx, quantize_after_mult_and_add=qama),
        approx=mod.ApproxConfig(expo_width=expo, mant_width=mant, with_comp=approx,
                                with_approx=approx, with_s2nn2s_opt=s2nn2s))


def _tree(tree):
    return jax.tree.map(np.asarray, dict(tree))


# 3x3 stride 2 with explicit padding: MobileNetV2's stem and depthwise convs
CONV_3X3 = dict(kernel_size=(3, 3), strides=(2, 2), padding=[(1, 1), (1, 0)])
# ResNet's stem at C_IN = 3 (K = 147, not a multiple of K3's BK = 8) and its
# strided 1x1 downsample
CONV_STEM = dict(kernel_size=(7, 7), strides=(2, 2), padding=[(3, 3), (3, 3)])
CONV_DOWNSAMPLE = dict(kernel_size=(1, 1), strides=(2, 2), padding=[(0, 0), (0, 0)])
# spatial rank 3 (an R3D-style 3x3x3 block, strided in depth)
CONV_3D = dict(kernel_size=(3, 3, 3), strides=(2, 1, 1), padding=[(1, 1), (1, 0), (0, 1)])
# the input's spatial size, cut to the conv's rank
SPATIAL = (7, 6, 5)


def _conv_pair(qc_args, groups, *, bn=False, rng, values="int", conv=CONV_3X3, c_in=C_IN,
               jit_init=False):
    """A JAX conv and the port's counterpart carrying its init (jitted with
    ``jit_init``), both at ``conv``'s kernel, strides and padding; the kernel
    and (for the plain conv) bias replaced by small integers. Returns (jax
    module, variables, port module, x)."""
    jcls = jlayers.BNQuantConv if bn else jlayers.QuantConv
    tcls = tlayers.BNQuantConv if bn else tlayers.QuantConv
    kw = dict(conv, feature_group_count=groups, use_bias=not bn)
    size = (2, *SPATIAL[:len(conv["kernel_size"])], c_in)
    if values == "int":
        x = rng.integers(-3, 4, size=size).astype(np.float32)
    else:
        # magnitudes across many binades: some products round to zero on
        # the result grid
        x = (rng.normal(size=size) * np.exp2(rng.integers(-9, 3, size=size))).astype(np.float32)
    jm = jcls(qc=_qc(jc, **qc_args), features=C_OUT, **kw)
    init = jax.jit(jm.init, static_argnums=2) if jit_init else jm.init
    variables = init(jax.random.key(1), jnp.asarray(x), jsites.ESTIMATE)
    params = dict(variables["params"])
    shape = (*conv["kernel_size"], c_in // groups, C_OUT)
    params["kernel"] = jnp.asarray(rng.integers(-2, 3, size=shape).astype(np.float32)
                                   if values == "int" else
                                   rng.normal(size=shape).astype(np.float32))
    if bn:
        params["gamma"] = jnp.asarray(rng.uniform(0.5, 2.0, size=C_OUT).astype(np.float32))
        params["beta"] = jnp.asarray(rng.normal(size=C_OUT).astype(np.float32))
    else:
        params["bias"] = jnp.asarray(rng.integers(-2, 3, size=C_OUT).astype(np.float32))
    variables = {**variables, "params": params}
    tm = tcls(_qc(tc, **qc_args), c_in, C_OUT, **kw)
    tm.load_state_dict(from_jax_variables(_tree(variables)), strict=True)
    return jm, variables, tm, x


def _apply(jm, variables, x, qp, jit, **kw):
    """``jm.apply``, jitted for the grouped approx convs: op by op, the
    vmapped oracle compiles each of its ops on its own."""
    fn = lambda v, x: jm.apply(v, x, qp, **kw)  # noqa: E731
    return (jax.jit(fn) if jit else fn)(variables, jnp.asarray(x))


def _estimate(jm, variables, tm, x, jit=False):
    """ESTIMATE on both sides; the site state must be equal. Returns the
    calibrated JAX variables."""
    _, ups = _apply(jm, variables, x, jsites.ESTIMATE, jit, mutable=["quant", "quant_est"])
    variables = {**variables, **ups}
    with torch.no_grad():
        tm(torch.from_numpy(x), tsites.ESTIMATE)
    expect = from_jax_variables(_tree({k: variables[k] for k in ("quant", "quant_est")}))
    got = tm.state_dict()
    for key, value in expect.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)
    return variables


def _launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


@pytest.mark.parametrize("groups", [1, 2, C_IN], ids=["g1", "g2", "depthwise"])
def test_grouped_quant_conv_matches_jax(groups, rng):
    """ESTIMATE (site state), then FP32, FIXED, FAST and PACKED outputs, and
    the packed codes of the ``(3, 3, I/g, O)`` kernel: bit for bit."""
    x_in = rng.integers(-3, 4, size=(2, 7, 6, C_IN)).astype(np.float32)
    jm, variables, tm, x = _conv_pair({}, groups, rng=rng)
    variables = _estimate(jm, variables, tm, x)
    launches = _launches()
    j_phase = {"FP32": jsites.FP32, "FIXED": jsites.FIXED, "FAST": jsites.FAST}
    t_phase = {"FP32": tsites.FP32, "FIXED": tsites.FIXED, "FAST": tsites.FAST}
    with torch.no_grad():
        for name in ("FP32", "FIXED", "FAST"):
            want = np.asarray(jm.apply(variables, jnp.asarray(x_in), j_phase[name]),
                              np.float32)
            got = tm(torch.from_numpy(x_in), t_phase[name]).float().numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)

    jv = j_cache(jm, variables, jnp.zeros((1, 7, 6, C_IN)), fast=True)
    jv, _ = j_pack(jv, _qc(jc))
    t_cache(tm, np.zeros((1, 7, 6, C_IN), np.float32), fast=True)
    t_pack(tm, _qc(tc))
    theirs = from_jax_variables(_tree({"quant_cache": jv["quant_cache"]}))
    assert tm.w_codes.shape == (9 * C_IN // groups, C_OUT)
    for key in ("w_codes", "w_pack_bias"):
        np.testing.assert_array_equal(getattr(tm, key).numpy(), theirs[key].numpy(), err_msg=key)
    want = np.asarray(jm.apply(jv, jnp.asarray(x_in), jsites.PACKED), np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x_in), tsites.PACKED).float().numpy()
    np.testing.assert_array_equal(got, want, err_msg="PACKED")
    assert _launches() == launches                  # CPU tensors: plain versions


@pytest.mark.parametrize("case", [
    dict(groups=1), dict(groups=1, conv=CONV_STEM, c_in=3),
    dict(groups=1, conv=CONV_DOWNSAMPLE), dict(groups=C_IN),
    dict(groups=C_IN, expo=2, mant=5, s2nn2s=True, values="grid"),
    dict(groups=C_IN, conv=CONV_3D),
], ids=["g1_k3", "stem_7x7_k147", "downsample_1x1_s2", "depthwise_oracle",
        "depthwise_e2m5_s2nn2s", "depthwise_oracle_3d"])
def test_approx_quant_conv_matches_jax(case, rng, monkeypatch):
    """The approx run method through ESTIMATE then FIXED: g = 1 through K3's
    plain version against JAX's Pallas kernel in interpret mode (at a 3x3
    conv, at ResNet's 7x7 stem with K = 147 and at its strided 1x1
    downsample), grouped convs through the port's oracle against JAX's
    vmapped jnp oracle (with its raw-product zero mask, which the E2M5
    s2nn2s case exercises), a depthwise conv of spatial rank 3 too."""
    case = dict(case)
    groups, values = case.pop("groups"), case.pop("values", "int")
    shape = dict(conv=case.pop("conv", CONV_3X3), c_in=case.pop("c_in", C_IN))
    oracle_calls = []
    real = tlayers.approx_matmul_oracle

    def counted(*args, **kw):
        oracle_calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tlayers, "approx_matmul_oracle", counted)
    jm, variables, tm, x = _conv_pair(dict(approx=True, **case), groups, rng=rng,
                                      values=values, **shape)
    variables = _estimate(jm, variables, tm, x, jit=groups > 1)
    want = np.asarray(_apply(jm, variables, x, jsites.FIXED, jit=groups > 1))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), tsites.FIXED).numpy()
    np.testing.assert_array_equal(got, want)
    # the grouped convs went through the oracle, all groups in one call
    assert [s[0] for s in oracle_calls] == ([] if groups == 1 else [groups, groups])


def test_qama_grouped_quant_conv_matches_jax(rng):
    """Quantize-after-mult-and-add on a grouped conv through ESTIMATE then
    FIXED: every product on the res site's grid, summed, and the sum
    requantized, a group at a time. Integer operands keep every sum exact,
    so the outputs agree bit for bit; no kernel launches."""
    jm, variables, tm, x = _conv_pair(dict(qama=True), 2, rng=rng, jit_init=True)
    before = _launches()
    variables = _estimate(jm, variables, tm, x, jit=True)
    want = np.asarray(_apply(jm, variables, x, jsites.FIXED, jit=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), tsites.FIXED).numpy()
    np.testing.assert_array_equal(got, want)
    assert _launches() == before


def test_grouped_oracle_matches_jax_oracle():
    """``approx_matmul_oracle`` over a leading group axis against JAX's
    ``approx_matmul_2d(allow_pallas=False)`` under ``jax.vmap``, on the
    E2M5 value space under s2nn2s with per-group weight biases and low
    result biases: bit for bit, at a K where the chunked rows and the
    ascending sum both matter; and the requantized mask (K3's) differs
    there, so the raw one is what the grouped convs need."""
    expo, mant = 2, 5
    approx_t = tc.ApproxConfig(expo_width=expo, mant_width=mant, with_comp=True,
                               with_approx=True, with_s2nn2s_opt=True)
    approx_j = jc.ApproxConfig(expo_width=expo, mant_width=mant, with_comp=True,
                               with_approx=True, with_s2nn2s_opt=True)
    vs = value_space(expo, mant, 3)
    space = torch.cat([vs, -vs[1:]])
    g, k = 3, 9
    a = space[torch.arange(g * 40 * k) % space.numel()].reshape(g, 40, k)
    b = space.flip(0)[torch.arange(g * k * 5) % space.numel()].reshape(g, k, 5)
    bias_b = torch.tensor([[3, 4, 5, 6, 7], [2, 3, 4, 5, 6], [4, 5, 6, 7, 8]], dtype=torch.int32)
    for br in (-6, -3):
        ours = tlayers.approx_matmul_oracle(a, b, torch.tensor(3), bias_b, torch.tensor(br),
                                            approx_t)
        theirs = np.asarray(jax.jit(jax.vmap(lambda p, w, wb: jlayers.approx_matmul_2d(
            p, w, 3, wb, br, approx_j, allow_pallas=False)))(
                jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), jnp.asarray(bias_b.numpy())))
        np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=f"bias_r {br}")
        requant = torch.stack([approx_matmul_golden(
            a[i], b[i], expo, mant, 3, bias_b[i], br, get_error_table(expo, mant, True, 3),
            with_s2nn2s_opt=True) for i in range(g)])
        assert not torch.equal(requant, ours)
    # rows in chunks: the same result from a budget of one product row
    small = functools.partial(tlayers.approx_matmul_oracle, a, b, torch.tensor(3), bias_b,
                              torch.tensor(-6), approx_t)
    whole = small()
    old = tlayers.ORACLE_CHUNK_ELEMENTS
    try:
        tlayers.ORACLE_CHUNK_ELEMENTS = 1
        np.testing.assert_array_equal(small().numpy(), whole.numpy())
    finally:
        tlayers.ORACLE_CHUNK_ELEMENTS = old


def test_bn_quant_conv_and_reestimation_match_jax(rng):
    """``BNQuantConv`` (depthwise, ReLU6) through ESTIMATE, FIXED and BN
    re-estimation over two batches (``eval.driver.reestimate_bn`` on both
    sides), then CHAINED (the BN folded into a pending ``Affine`` with
    ReLU6's clamp): site state bit for bit; running stats and outputs within
    ``rtol=atol=1e-6`` (module docstring)."""
    from fp8_quantization_tpu.ops.activations import relu6 as j_relu6
    from fp8_quantization_tpu_torch.ops.activations import relu6 as t_relu6

    jm, variables, tm, x = _conv_pair({}, C_IN, bn=True, rng=rng)
    jm = jm.clone(activation=j_relu6)
    tm.activation = t_relu6
    stats = {"mean": rng.normal(size=C_OUT).astype(np.float32),
             "var": rng.uniform(0.5, 3.0, size=C_OUT).astype(np.float32)}
    variables = {**variables, "batch_stats": {k: jnp.asarray(v) for k, v in stats.items()}}
    tm.load_state_dict(from_jax_variables(_tree(variables)), strict=True)
    variables = _estimate(jm, variables, tm, x)
    tol = dict(rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x), tsites.FIXED).numpy(),
                                   np.asarray(jm.apply(variables, jnp.asarray(x))), **tol)
        batches = [rng.integers(-3, 4, size=(2, 7, 6, C_IN)).astype(np.float32)
                   for _ in range(2)]
        jv = j_reestimate(jm, variables, batches)
        t_reestimate(tm, batches)
        for key in ("mean", "var"):
            assert not np.allclose(np.asarray(jv["batch_stats"][key]), stats[key])
            np.testing.assert_allclose(getattr(tm, key).numpy(),
                                       np.asarray(jv["batch_stats"][key]), err_msg=key, **tol)
        np.testing.assert_allclose(tm(torch.from_numpy(x), tsites.FIXED).numpy(),
                                   np.asarray(jm.apply(jv, jnp.asarray(x))), **tol)
        # the fused boundary: BN leaves as a pending Affine, ReLU6 sets its
        # clamp; its value within the same tolerance of JAX's
        want = jm.apply(jv, jnp.asarray(x), jsites.CHAINED)
        got = tm(torch.from_numpy(x), tsites.CHAINED)
        assert isinstance(want, jsites.Affine) and isinstance(got, tsites.Affine)
        assert (got.lo, got.hi) == (0.0, 6.0)
        np.testing.assert_allclose(tsites.decoded(got).numpy(),
                                   np.asarray(jsites.decoded(want)), **tol)
