"""The packed-FP8 codec, the bit-ops quantizer (K1), the fused quant GEMM
(K2), the dequant GEMM (K4) and the fast path of the port against the JAX
package, on the same numpy inputs.

* Codec, packing and K1: bit-exact (``np.array_equal``; -0.0 and +0.0 count
  as equal where the two frameworks' min/max order signed zeros apart).
* K2 and K4 plain versions against ``fused_quant_matmul`` and
  ``dequant_matmul`` (Pallas interpret mode on the CPU): per element
  ``|d| <= K * 2^-24 * sum_k |x_k w_k|``. Every product of bf16 operands is
  exact in f32; only the order of the f32 sums differs between XLA's CPU dot
  and the port's ascending-k sum.

The CUDA kernels run only on a GPU: ``tests/test_torch_cuda.py`` holds them
against these plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.numerics import codec as jcodec
from fp8_quantization_tpu.numerics.fp8_ste import quantize_to_fp8_ste as j_ste
from fp8_quantization_tpu.ops import fastpath as jfast
from fp8_quantization_tpu.ops.pallas.dequant_matmul import dequant_matmul as j_dequant
from fp8_quantization_tpu.ops.pallas.dequant_matmul import pack_weights as j_pack
from fp8_quantization_tpu.ops.pallas.dequant_matmul import unpack_weights as j_unpack
from fp8_quantization_tpu.ops.pallas.fused_matmul import fused_quant_matmul as j_fused
from fp8_quantization_tpu.ops.pallas.fused_matmul import quantize_block as j_qblock
from fp8_quantization_tpu_torch.numerics import codec
from fp8_quantization_tpu_torch.numerics.fp8_ste import quantize_to_fp8_ste
from fp8_quantization_tpu_torch.ops import fastpath
from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as k4
from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as k2
from test_torch_cuda import k1_inputs, ste_weights

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

FORMATS = [(3, 4), (4, 3), (2, 5)]
# biases of ordinary grids, a negative one, and the saturated +inf bias of a
# site that saw only zeros (its int32 arithmetic wraps)
BIASES = [0, 3, 7, 12, 20, -5, 2 ** 31 - 1]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("expo,mant", FORMATS)
def test_codec_bit_exact_over_value_space(expo, mant):
    """value_space, pack_exmy, unpack_exmy, unpack_consts and
    unpack_exmy_bits over every code of the format, at several biases."""
    codes = np.arange(256, dtype=np.uint8)
    for bias in BIASES:
        vs = np.asarray(jcodec.value_space(expo, mant, bias))
        np.testing.assert_array_equal(_bits(codec.value_space(expo, mant, bias)), _bits(vs))
        vals = np.concatenate([vs, -vs])
        np.testing.assert_array_equal(
            codec.pack_exmy(_t(vals), expo, mant, bias).numpy(),
            np.asarray(jcodec.pack_exmy(vals, expo, mant, bias)))
        np.testing.assert_array_equal(
            codec.pack_exmy(_t(vals * 3), expo, mant, bias, clip_of=True).numpy(),
            np.asarray(jcodec.pack_exmy(vals * 3, expo, mant, bias, clip_of=True)))
        np.testing.assert_array_equal(
            _bits(codec.unpack_exmy(_t(codes), expo, mant, bias)),
            _bits(jcodec.unpack_exmy(codes, expo, mant, bias)))
        jeb, jss = jcodec.unpack_consts(bias, mant)
        teb, tss = codec.unpack_consts(bias, mant)
        assert int(teb) == int(jeb) and _bits(tss) == _bits(jss)
        np.testing.assert_array_equal(
            _bits(codec.unpack_exmy_bits(_t(codes), expo, mant, teb, tss)),
            _bits(jcodec.unpack_exmy_bits(codes, expo, mant, jeb, jss)))


@pytest.mark.parametrize("expo,mant", FORMATS)
def test_pack_roundtrip_and_fields(expo, mant):
    """Every code of the nominal format round-trips, -0.0 packing as +0.0;
    the flat code and its fields invert each other as in JAX."""
    codes = np.arange(256, dtype=np.uint8)
    back = codec.pack_exmy(codec.unpack_exmy(_t(codes), expo, mant, 2 ** (expo - 1)),
                           expo, mant, 2 ** (expo - 1)).numpy().astype(np.int32)
    expected = codes.astype(np.int32)
    expected[1 << (expo + mant)] = 0
    np.testing.assert_array_equal(back, expected)
    flat = np.arange(-40, 300, dtype=np.int32)
    e, m = codec.fields_of(_t(flat), mant)
    je, jm = jcodec.fields_of(flat, mant)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(codec.code_of(e, m, mant).numpy(), flat)


@pytest.mark.parametrize("mant,sign", [(4, 1), (4, 0), (3, 1), (5, 1), (2, 0)])
def test_quantize_block_matches_jax(mant, sign, rng):
    """K1's plain version equals JAX's quantize_block, and the port's STE
    quantizer (the FIXED phase's), bit for bit."""
    maxval = 2.75
    x = k1_inputs(rng, maxval, shape=(64, 48))
    ref, bias = quantize_to_fp8_ste(_t(x), 8, torch.tensor([maxval]), float(mant), sign)
    bias = int(bias[0])
    ours = k2.quantize_block(_t(x), maxval, bias, mant, sign)
    jax_ours = j_qblock(jnp.asarray(x), jnp.float32(maxval), jnp.int32(bias),
                        jnp.int32(mant), jnp.int32(sign))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_ours))
    np.testing.assert_array_equal(ours.numpy(), ref.numpy())


@pytest.mark.parametrize("maxval,bias", [(0.0, 2 ** 31 - 1), (1e30, -100), (1e-30, 120)])
def test_quantize_block_degenerate_scalars(maxval, bias, rng):
    """A site that saw only zeros (maxval 0, bias saturated from +inf) and
    grids at the ends of the f32 range: the int32 arithmetic wraps and
    clamps as XLA's does."""
    x = k1_inputs(rng, 4.0, shape=(64, 48))
    ours = k2.quantize_block(_t(x), torch.tensor(maxval), torch.tensor(float(bias)), 4, 1)
    theirs = j_qblock(jnp.asarray(x), jnp.float32(maxval),
                      jnp.float32(bias).astype(jnp.int32), jnp.int32(4), jnp.int32(1))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def _grid_weights(rng, k, n, mant, tiny_rows=True):
    wq, bias = ste_weights(rng, k, n, mant, tiny_rows)
    return wq.numpy(), bias.numpy()


@pytest.mark.parametrize("expo,mant", FORMATS)
def test_pack_weights_matches_jax(expo, mant, rng):
    wq, bias = _grid_weights(rng, 96, 40, mant)
    theirs = j_pack(jnp.asarray(wq), jnp.asarray(bias), expo, mant)
    ours = k4.pack_weights(_t(wq), _t(bias), expo, mant)
    np.testing.assert_array_equal(ours.codes.numpy(), np.asarray(theirs.codes))
    np.testing.assert_array_equal(ours.bias.numpy(), np.asarray(theirs.bias))
    assert float(ours.exact_fraction) == float(theirs.exact_fraction)
    assert 0.0 < float(ours.exact_fraction)
    np.testing.assert_array_equal(_bits(k4.unpack_weights(ours)),
                                  _bits(j_unpack(theirs)))


SHAPES = [(32, 64, 48), (13, 70, 29), (5, 130, 70)]
F32, BF16 = (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)


def _assert_sum_close(ours, theirs, x_eff, w_eff, requantized):
    ours = ours.to(torch.float32).numpy()
    theirs = np.asarray(theirs, np.float32)
    if requantized:
        # an ulp apart before the requant can land one grid step apart only
        # at a rounding midpoint; none of these inputs sits on one
        np.testing.assert_array_equal(ours, theirs)
        return
    tol = k2.sum_tolerance(_t(x_eff), _t(w_eff)).numpy()
    assert (np.abs(ours.astype(np.float64) - theirs) <= tol).all()


@pytest.mark.parametrize("m,k,n", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("quantize_x", [True, False], ids=["quant_x", "bf16_x"])
@pytest.mark.parametrize("requant", [False, True], ids=["f32_acc", "requant"])
@pytest.mark.parametrize("out", [F32, BF16], ids=["out_f32", "out_bf16"])
def test_fused_quant_matmul_plain_matches_jax(m, k, n, quantize_x, requant, out, rng):
    x = (rng.normal(size=(m, k)) * 2).astype(np.float32)
    wq, _ = _grid_weights(rng, k, n, 4, tiny_rows=False)
    act = (float(np.abs(x).max()), 5, 4, 1)
    res = (40.0, 2, 4, 1)
    xj = jnp.asarray(x) if quantize_x else jnp.asarray(x).astype(jnp.bfloat16)
    theirs = j_fused(xj, jnp.asarray(wq).astype(jnp.bfloat16), act, res,
                     quantize_x=quantize_x, requantize_out=requant, out_dtype=out[1],
                     bm=8, bn=8, bk=8)
    xt = _t(x) if quantize_x else _t(x).to(torch.bfloat16)
    before = k2.fused_quant_matmul.launches
    ours = k2.fused_quant_matmul(xt, _t(wq).to(torch.bfloat16), act, res,
                                 quantize_x=quantize_x, requantize_out=requant,
                                 out_dtype=out[0])
    assert k2.fused_quant_matmul.launches == before   # CPU tensors: plain version
    assert ours.dtype == out[0] and tuple(ours.shape) == (m, n)
    x_eff = (k2.quantize_block(_t(x), *act) if quantize_x else xt).to(torch.bfloat16)
    _assert_sum_close(ours, theirs, x_eff.float().numpy(), wq, requant)


def _x_forms(rng, m, k, expo, mant):
    """(name, torch x, jax x, keywords, effective bf16 x) for every x form
    of K4: bf16, f32 quantized on the load, f32 rounded to bf16, codes."""
    x = rng.normal(size=(m, k)).astype(np.float32)
    xq, _ = j_ste(jnp.asarray(x), 8, jnp.asarray([3.0]), float(mant), 1)
    act = (3.0, 12, mant, 1)
    codes = np.asarray(jcodec.pack_exmy(xq, expo, mant, 11, clip_of=True))
    xq16 = np.asarray(xq)
    x_codes = codec.unpack_exmy(_t(codes), expo, mant, 11).numpy()
    return [
        ("bf16", _t(xq16).to(torch.bfloat16), jnp.asarray(xq16).astype(jnp.bfloat16), {}, xq16),
        ("f32_quant", _t(x), jnp.asarray(x), dict(quantize_x=True, act_params=act),
         k2.quantize_block(_t(x), *act).numpy()),
        ("f32", _t(x), jnp.asarray(x), {}, _t(x).to(torch.bfloat16).float().numpy()),
        ("codes", _t(codes), jnp.asarray(codes), dict(x_bias=11, x_expo=expo, x_mant=mant),
         x_codes),
    ]


@pytest.mark.parametrize("expo,mant", FORMATS)
@pytest.mark.parametrize("m,k,n", SHAPES[1:], ids=lambda v: str(v))
def test_dequant_matmul_plain_matches_jax(expo, mant, m, k, n, rng):
    """Every x form, with and without the res requant, f32 and bf16 out."""
    wq, bias = _grid_weights(rng, k, n, mant)
    pw = j_pack(jnp.asarray(wq), jnp.asarray(bias), expo, mant)
    codes, wbias = _t(np.asarray(pw.codes)), _t(np.asarray(pw.bias))
    w_eff = np.asarray(j_unpack(pw))
    res = (6.0, 8, mant, 1)
    for name, xt, xj, kw, x_eff in _x_forms(rng, m, k, expo, mant):
        for requant in (False, True):
            for out in (F32, BF16):
                theirs = j_dequant(xj, pw.codes, pw.bias, expo_width=expo, mant_width=mant,
                                   res_params=res, requantize_out=requant,
                                   out_dtype=out[1], bm=8, bn=8, bk=8, **kw)
                ours = k4.dequant_matmul(xt, codes, wbias, expo_width=expo,
                                         mant_width=mant, res_params=res,
                                         requantize_out=requant, out_dtype=out[0], **kw)
                assert ours.dtype == out[0], name
                _assert_sum_close(ours, theirs, x_eff, w_eff, requant)


def test_sequential_matmul_is_ascending_k(rng):
    """The plain GEMMs' sum: f32, one k at a time, in ascending order."""
    a = rng.normal(size=(3, 9)).astype(np.float32)
    b = rng.normal(size=(9, 4)).astype(np.float32)
    acc = np.zeros((3, 4), np.float32)
    for kk in range(9):
        acc = (acc + np.outer(a[:, kk], b[kk]).astype(np.float32)).astype(np.float32)
    ours = k2.sequential_matmul(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(ours, acc, rtol=1e-6)


def test_kernels_reject_what_they_do_not_take():
    z = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        k2.fused_quant_matmul(z, z.T.contiguous())            # f32 weights
    with pytest.raises(TypeError):
        k2.fused_quant_matmul(z.to(torch.bfloat16), z.T.to(torch.bfloat16))  # quantize bf16
    with pytest.raises(ValueError):
        k2.fused_quant_matmul(z, z.to(torch.bfloat16))        # K mismatch
    codes = torch.zeros(8, 3, dtype=torch.uint8)
    with pytest.raises(TypeError):
        k4.dequant_matmul(z, codes.float(), torch.zeros(3), expo_width=3, mant_width=4)
    with pytest.raises(TypeError):
        k4.dequant_matmul(z.to(torch.uint8), codes, torch.zeros(3), expo_width=3,
                          mant_width=4)                       # codes without x_bias


def test_quantized_matmul_matches_jax(rng):
    """``fastpath.quantized_matmul`` (x quantized on K2's load, bf16
    product, bias, K1 on the result) and ``scalar_params`` against JAX."""
    x = (rng.normal(size=(24, 40)) * 2).astype(np.float32)
    wq, _ = _grid_weights(rng, 40, 16, 4, tiny_rows=False)
    b = rng.normal(size=16).astype(np.float32)
    state = {"maxval": np.array([3.5], np.float32), "mantissa_bits": np.array([4.0], np.float32),
             "sign_bits": np.array([1], np.int32)}
    from fp8_quantization_tpu.config import QMethod as JQM, QuantizerConfig as JQC
    from fp8_quantization_tpu_torch.config import QMethod, QuantizerConfig

    jsp = jfast.scalar_params(JQC(method=JQM.fp_quantizer), {k: jnp.asarray(v)
                                                              for k, v in state.items()})
    tsp = fastpath.scalar_params(QuantizerConfig(method=QMethod.fp_quantizer),
                                 {k: _t(v) for k, v in state.items()})
    for a, c in zip(tsp, jsp):
        assert float(a) == float(c)
    theirs = jfast.quantized_matmul(jnp.asarray(x), jnp.asarray(wq).astype(jnp.bfloat16),
                                    jsp, jsp, jnp.asarray(b))
    ours = fastpath.quantized_matmul(_t(x), _t(wq).to(torch.bfloat16), tsp, tsp, _t(b))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("with_act", [True, False], ids=["quant_x", "bf16_x"])
def test_quantized_matmul_batched_matches_jax(with_act, rng):
    """Batched (3-D) input without a bias, as ``QuantDense`` passes it:
    f32 x quantized on K2's load, or bf16 grid values with no act
    quantizer, as the fast phase's dense product runs it."""
    x = (rng.normal(size=(2, 12, 40)) * 2).astype(np.float32)
    wq, _ = _grid_weights(rng, 40, 16, 4, tiny_rows=False)
    act = fastpath.ScalarQuantParams(*(torch.tensor(v) for v in (3.5, 5, 4, 1)))
    res = fastpath.ScalarQuantParams(*(torch.tensor(v) for v in (30.0, 2, 4, 1)))
    jact, jres = (jfast.ScalarQuantParams(*(jnp.asarray(v.numpy()) for v in p))
                  for p in (act, res))
    xt = _t(x) if with_act else k2.quantize_block(_t(x), *act).to(torch.bfloat16)
    xj = jnp.asarray(xt.float().numpy())
    xj = xj if with_act else xj.astype(jnp.bfloat16)
    theirs = jfast.quantized_matmul(xj, jnp.asarray(wq).astype(jnp.bfloat16),
                                    jact if with_act else None, jres)
    ours = fastpath.quantized_matmul(xt, _t(wq).to(torch.bfloat16),
                                     act if with_act else None, res)
    assert tuple(ours.shape) == (2, 12, 16)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_finalized_dense_matches_jax(rng):
    """``finalize_dense`` of a calibrated ``QuantDense`` loaded from JAX's
    variables, applied with ``fast_dense_apply``, against JAX's."""
    import jax

    from fp8_quantization_tpu import config as jc
    from fp8_quantization_tpu.ops.layers import QuantDense as JDense
    from fp8_quantization_tpu.quant import sites as jsites
    from fp8_quantization_tpu_torch import config as tc
    from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
    from fp8_quantization_tpu_torch.ops.layers import QuantDense as TDense
    from test_torch_vit import _numpy_tree, _qc

    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    jqc = _qc(jc, False)
    jl = JDense(qc=jqc, features=24)
    v = jl.init(jax.random.key(1), jnp.asarray(x), jsites.ESTIMATE)
    _, ups = jl.apply(v, jnp.asarray(x), jsites.ESTIMATE, mutable=["quant", "quant_est"])
    v = {**v, **ups}
    tl = TDense(_qc(tc, False), 32, 24)
    tl.load_state_dict(from_jax_variables(_numpy_tree(v)), strict=True)
    jp = jfast.finalize_dense(jqc, v["params"], v["quant"])
    tp = fastpath.finalize_dense(tl)
    np.testing.assert_array_equal(tp.w16.float().numpy(), np.asarray(jp.w16, np.float32))
    for ours, theirs in ((tp.act, jp.act), (tp.res, jp.res)):
        assert [float(a) for a in ours] == [float(b) for b in theirs]
    np.testing.assert_array_equal(
        fastpath.fast_dense_apply(tp, _t(x)).detach().numpy(),
        np.asarray(jfast.fast_dense_apply(jp, jnp.asarray(x))))
