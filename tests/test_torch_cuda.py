"""The CUDA kernels on the card against their plain PyTorch versions: K3
(approximate-multiplier GEMM), K1 (bit-ops quantizer), K2 (fused quant GEMM),
K4 (packed-FP8 dequant GEMM), K5 (int4 nibble GEMM), K7 (fused SDPA) and K6
(decode attention).

Every test here needs a GPU (marker ``cuda``) and skips without one: the
kernel has no CPU mode. The file imports neither JAX nor the JAX package, so
it also runs on a GPU machine that has no JAX, without ``tests/conftest.py``
(which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

K3's flag cases are the eight of ``tests/test_approx_pallas.py``;
``tests/test_torch_approx_matmul.py`` holds the plain version against JAX on
the same cases. Tolerance ``rtol=atol=1e-6``, the Pallas tests' own, for
K <= 64: only the summation order over K separates the two.

K1 must equal its plain version exactly (equal values; -0.0 and +0.0 alike).
K2 and K4 take one of two routes by M (``fused_matmul.gemm_route``). Route A
(M <= 16, decode) sums the exact bf16 products in f32 in ascending k, as the
plain versions do, so it must equal them exactly. Route B (tensor cores)
sums in another order: before any requant it must lie within ``K * 2^-24 *
sum_k |x_k w_k|`` of the plain sum, and after the requant epilogue equal the
plain output or be one step of the result grid away where the plain sum is
within that tolerance of a rounding midpoint, with at least 99% equal
(``fused_matmul.within_requant_step``).

K3 also equals its plain version bit for bit on every single product
(K = 1) of the value spaces across the result biases: its table path
(``approx_matmul.table_products``) is exact per product, and only the
summation order over K separates it from the plain sum.

K5's integer sums are exact in any order: it must equal its plain version
bit for bit on both routes and at the route edge.

K7 runs ``q k^T`` and ``p v`` on the tensor cores, which sum in their own
order: it is held to ``attention.within_sdpa_contract`` (a bound derived from
the summation order alone: scores within their f32 order term, each bf16
probability the plain one or a neighbour where that can move it across a
rounding point, the context within those flips plus the order term of
``p v``; with the requant epilogue equal or one grid step away at a rounding
midpoint, at least 99% equal), and its requant epilogue must equal the plain
``quantize_block`` of the kernel's own context exactly. K6 sums in the order
its plain version takes (sub-chunks of 64 keys, partial sums added in
ascending order) and must equal it bit for bit.
"""

import numpy as np
import pytest
import torch

from fp8_quantization_tpu_torch.numerics.codec import pack_exmy, quantize_exmy, value_space
from fp8_quantization_tpu_torch.numerics.fp8_ste import quantize_to_fp8_ste
from fp8_quantization_tpu_torch.ops.cuda import approx_matmul as k3
from fp8_quantization_tpu_torch.ops.cuda import attention as k7
from fp8_quantization_tpu_torch.ops.cuda import decode_attention as k6
from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as k4
from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as k2

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

TOL = dict(rtol=1e-6, atol=1e-6)

# the eight flag cases of tests/test_approx_pallas.py, as the wrapper's keywords
CASES = [
    dict(expo_width=3, mant_width=4, with_comp=True),
    dict(expo_width=3, mant_width=4, with_comp=False),
    dict(expo_width=3, mant_width=4, with_comp=True, quant_btw_mult_accu=False),
    dict(expo_width=3, mant_width=4, with_comp=True, with_s2nn2s_opt=True),
    dict(expo_width=4, mant_width=3, with_comp=False),
    dict(expo_width=2, mant_width=5, with_comp=True),
    dict(expo_width=3, mant_width=4, with_comp=True, with_approx=False),
    dict(expo_width=3, mant_width=4, with_comp=True, golden_clip_of=True),
]
FLAGSHIP = CASES[0]


def case_id(case):
    flags = "".join(tag for key, tag in (("with_comp", "c"), ("with_approx", "a"),
                                         ("quant_btw_mult_accu", "q"),
                                         ("with_s2nn2s_opt", "s"), ("golden_clip_of", "x"))
                    if case.get(key, key in ("with_approx", "quant_btw_mult_accu")))
    return f"E{case['expo_width']}M{case['mant_width']}{flags}"


def grid_operands(rng, m, k, n, ew, mw, bias_a, bias_b):
    """Numpy (M, K) and (K, N) operands on their ExMy grids; ``bias_b`` is a
    scalar or an (N,) per-column bias."""
    a = quantize_exmy(torch.from_numpy((rng.normal(size=(m, k)) * 2).astype(np.float32)),
                      ew, mw, bias_a).numpy()
    bb = torch.as_tensor(np.asarray(bias_b)).reshape(1, -1)
    b = quantize_exmy(torch.from_numpy((rng.normal(size=(k, n)) * 2).astype(np.float32)),
                      ew, mw, bb).numpy()
    return a, b


@pytest.fixture
def rng():
    """Seeded inputs (this file runs without ``tests/conftest.py`` on the card)."""
    return np.random.default_rng(10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_and_plain(dev, a, b, bias_a, bias_b, bias_r, **kw):
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    tbb = torch.as_tensor(np.asarray(bias_b), device=dev)
    before = k3.approx_matmul.launches
    ours = k3.approx_matmul(ta, tb, bias_a, tbb, bias_r, **kw)
    torch.cuda.synchronize()
    assert k3.approx_matmul.launches == before + 1
    plain = k3.approx_matmul_plain(ta, tb, bias_a, tbb, bias_r, **kw)
    return ours.cpu().numpy(), plain.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(10)
    bias_b = np.resize(np.arange(3, 9, dtype=np.int32), 70)
    a, b = grid_operands(rng, 70, 40, 70, case["expo_width"], case["mant_width"], 5, bias_b)
    ours, plain = _kernel_and_plain(cuda, a, b, 5, bias_b, 4, **case)
    np.testing.assert_allclose(ours, plain, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (13, 17, 9), (130, 64, 129)])
def test_kernel_ragged_shapes(cuda, m, k, n):
    """Shapes off the 64x64 output tile and the 16-deep K slice."""
    rng = np.random.default_rng(m + k + n)
    a, b = grid_operands(rng, m, k, n, 3, 4, 5, 6)
    ours, plain = _kernel_and_plain(cuda, a, b, 5, 6, 4, **FLAGSHIP)
    np.testing.assert_allclose(ours, plain, **TOL)


@pytest.mark.cuda
def test_kernel_zero_operand_with_degenerate_bias(cuda):
    """A site that saw only zeros has bias +inf: the kernel's LUT reads stay
    in bounds and the zero operand's products stay zero."""
    rng = np.random.default_rng(3)
    _, b = grid_operands(rng, 1, 40, 70, 3, 4, 5, 7)
    a = np.zeros((70, 40), np.float32)
    for s2 in (False, True):
        ours, plain = _kernel_and_plain(cuda, a, b, torch.tensor(np.inf), np.full(70, 7.0),
                                        torch.tensor(np.inf), **FLAGSHIP,
                                        with_s2nn2s_opt=s2)
        np.testing.assert_array_equal(ours, np.zeros((70, 70), np.float32))
        np.testing.assert_array_equal(plain, ours)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros((4, 8), device=cuda)
    with pytest.raises(TypeError):
        k3.approx_matmul(a.double(), a.T.double(), 5, 6, 4, **FLAGSHIP)
    with pytest.raises(ValueError):
        k3.approx_matmul(a, a.cpu().T, 5, 6, 4, **FLAGSHIP)
    with pytest.raises(ValueError):
        k3.approx_matmul(a, a, 5, 6, 4, **FLAGSHIP)


@pytest.mark.cuda
def test_kernel_s2nn2s_on_every_single_product(cuda):
    """K3 with s2nn2s on every single product of the E2M5 value space on a
    low result grid, where the zero mask decides (see
    ``test_torch_approx_matmul.py::test_s2nn2s_zero_mask_on_every_single_product``)."""
    vs = value_space(2, 5, 2)
    a = torch.cat([vs, -vs[1:]]).reshape(-1, 1).numpy()
    vb = value_space(2, 5, 3)
    b = torch.cat([vb, -vb[1:]]).reshape(1, -1).numpy()
    for br in (-6, -3, 0):
        ours, plain = _kernel_and_plain(cuda, a, b, 2, 3, br, expo_width=2, mant_width=5,
                                        with_comp=True, with_s2nn2s_opt=True)
        np.testing.assert_array_equal(ours, plain)


# operand biases and a sweep of result biases that lands the single
# products in every binade of the result grid (as tests/test_torch_approx_table.py)
SPACE_BIASES = ((5, 3), (2, 9))
SPACE_BIAS_R = tuple(range(-12, 30, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_kernel_single_products_over_value_space(cuda, case):
    """Every single product (K = 1) of value space x value space, in each
    flag case and across the result biases: the kernel's table path equal to
    its plain version bit for bit (a zero's sign aside, which no sum that
    starts at +0 keeps)."""
    flags = {"with_approx": True, **case}
    ew, mw = case["expo_width"], case["mant_width"]
    for ba, bb in SPACE_BIASES:
        va, vb = value_space(ew, mw, ba), value_space(ew, mw, bb)
        a = torch.cat([va, -va[1:]]).reshape(-1, 1).numpy()
        b = torch.cat([vb, -vb[1:]]).reshape(1, -1).numpy()
        for br in SPACE_BIAS_R:
            ours, plain = _kernel_and_plain(cuda, a, b, ba, bb, br, **flags)
            np.testing.assert_array_equal((ours + 0.0).view(np.int32),
                                          (plain + 0.0).view(np.int32),
                                          err_msg=f"biases {ba} {bb} {br}")


def k1_inputs(rng, maxval, shape=(33, 67)):
    """Random values with zeros, f32 subnormals, +-maxval, the clip edges
    and huge values written into the first elements."""
    x = (rng.normal(size=shape) * maxval).astype(np.float32)
    edges = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-39, maxval, -maxval,
                      np.nextafter(np.float32(maxval), np.float32(0)),
                      np.nextafter(np.float32(maxval), np.float32(np.inf)),
                      -np.nextafter(np.float32(maxval), np.float32(np.inf)),
                      3e38, -3e38, 1e-3, 0.5, -2.0], np.float32)
    x.reshape(-1)[:edges.size] = edges
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("maxval,mant,sign", [(2.75, 4, 1), (2.75, 4, 0), (100.0, 3, 1),
                                              (0.02, 5, 1), (0.0, 4, 1)])
def test_quantize_block_matches_plain(cuda, rng, maxval, mant, sign):
    x = k1_inputs(rng, maxval or 1.0)
    bias = quantize_to_fp8_ste(torch.from_numpy(x), 8, torch.tensor([maxval]), float(mant),
                               sign)[1].reshape(())
    xt = torch.from_numpy(x).to(cuda)
    for view in (xt, xt[:, 1:]):          # an aligned tensor and an unaligned one
        before = k2.quantize_block.launches
        ours = k2.quantize_block(view, torch.tensor(maxval, device=cuda), bias.to(cuda),
                                 mant, sign)
        torch.cuda.synchronize()
        assert k2.quantize_block.launches == before + 1
        plain = k2.quantize_block_plain(view, maxval, bias, mant, sign)
        assert torch.equal(ours, plain)


@pytest.mark.cuda
def test_quantize_block_past_one_grid(cuda, rng):
    """The size of ViT-B/16's MLP activations at batch 8, more elements than
    one pass of the kernel's grid covers: its grid-stride loop, aligned and
    not."""
    x = torch.from_numpy(k1_inputs(rng, 3.0, shape=(197 * 8, 3072))).to(cuda)
    args = (torch.tensor(3.0, device=cuda), torch.tensor(5, device=cuda), 4, 1)
    for view in (x, x.reshape(-1)[1:]):
        before = k2.quantize_block.launches
        ours = k2.quantize_block(view, *args)
        torch.cuda.synchronize()
        assert k2.quantize_block.launches == before + 1
        assert torch.equal(ours, k2.quantize_block_plain(view, *args))


def ste_weights(rng, k, n, mant, tiny_rows=True):
    """STE-quantized (K, N) weights with their per-column biases, as a
    calibrated per-channel weight site gives them; with ``tiny_rows`` an
    eighth of the rows is tiny, so subnormal codes occur."""
    w = rng.normal(size=(k, n)).astype(np.float32)
    if tiny_rows:
        w[: k // 8] *= 1e-6
    mv = torch.from_numpy(np.abs(w).max(axis=0, keepdims=True))
    wq, bias = quantize_to_fp8_ste(torch.from_numpy(w), 8, mv, float(mant), 1)
    return wq, bias.reshape(-1)


def _assert_gemm(ours, plain, x_eff, w_eff, plain_sum, res=None):
    """Route A: equal to the plain output. Route B: ``within_requant_step``
    of the plain f32 sum (``res``: the requant scalars when the epilogue
    ran). Both: within the sum tolerance before any requant."""
    m, k = x_eff.shape
    tol = k2.sum_tolerance(x_eff, w_eff)
    if k2.gemm_route(m) == "A":
        assert torch.equal(ours.float(), plain.float())
    else:
        ok, info = k2.within_requant_step(ours, plain_sum, tol, res)
        assert ok, info
    if res is None and ours.dtype == torch.float32:
        assert bool(((ours.double() - plain_sum.double()).abs() <= tol).all())


# the four ViT-B/16 dense shapes on a row slice, an unaligned one, and the
# full batch-8 MLP output product (many row blocks)
GEMM_SHAPES = [(64, 768, 768), (64, 768, 3072), (64, 3072, 768), (8, 768, 1000),
               (13, 70, 29), (1576, 3072, 768)]
# Llama-3-8B's k/v projection (K 4096, N 1024) on each side of the route
# threshold: M = 1, 2 and 4 decode slots, 16 and 17 rows
LLAMA_GEMM_SHAPES = [(m, 4096, 1024) for m in (1, 2, 4, 16, 17)]


def _check_fused_quant_matmul(dev, rng, m, k, n):
    x = torch.from_numpy((rng.normal(size=(m, k)) * 2).astype(np.float32)).to(dev)
    wq, _ = ste_weights(rng, k, n, 4)
    w16 = wq.to(dev).to(torch.bfloat16)
    act = (float(x.abs().max()), 5, 4, 1)
    res = (40.0, 2, 4, 1)
    for quantize_x in (True, False):
        xin = x if quantize_x else x.to(torch.bfloat16)
        x_eff = (k2.quantize_block_plain(x, *act) if quantize_x else xin).to(torch.bfloat16)
        plain_sum = k2.fused_quant_matmul_plain(xin, w16, act, res, quantize_x=quantize_x)
        for requant in (False, True):
            for out_dtype in (torch.float32, torch.bfloat16):
                kw = dict(quantize_x=quantize_x, requantize_out=requant, out_dtype=out_dtype)
                before = k2.fused_quant_matmul.launches
                ours = k2.fused_quant_matmul(xin, w16, act, res, **kw)
                torch.cuda.synchronize()
                assert k2.fused_quant_matmul.launches == before + 1
                plain = k2.fused_quant_matmul_plain(xin, w16, act, res, **kw)
                assert ours.dtype == out_dtype
                _assert_gemm(ours, plain, x_eff.float(), w16.float(), plain_sum,
                             res if requant else None)


def _check_dequant_matmul(dev, rng, m, k, n):
    wq, bias = ste_weights(rng, k, n, 4)
    pw = k4.pack_weights(wq, bias, 3, 4)
    codes, wbias = pw.codes.to(dev), pw.bias.to(dev)
    w_eff = k4.unpack_weights(pw).to(dev)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    act = (3.0, 12, 4, 1)
    xq = k2.quantize_block_plain(x, *act)
    x_codes = pack_exmy(xq, 3, 4, 11, clip_of=True)
    forms = [(xq.to(torch.bfloat16), {}, xq),
             (x, dict(quantize_x=True, act_params=act), xq),
             (x, {}, x.to(torch.bfloat16).float()),
             (x_codes, dict(x_bias=11, x_expo=3, x_mant=4), xq)]
    res = (6.0, 8, 4, 1)
    for xin, kw, x_eff in forms:
        plain_sum = k4.dequant_matmul_plain(xin, codes, wbias, expo_width=3, mant_width=4,
                                            **kw)
        for requant in (False, True):
            for out_dtype in (torch.float32, torch.bfloat16):
                args = dict(expo_width=3, mant_width=4, res_params=res,
                            requantize_out=requant, out_dtype=out_dtype, **kw)
                before = k4.dequant_matmul.launches
                ours = k4.dequant_matmul(xin, codes, wbias, **args)
                torch.cuda.synchronize()
                assert k4.dequant_matmul.launches == before + 1
                plain = k4.dequant_matmul_plain(xin, codes, wbias, **args)
                assert ours.dtype == out_dtype
                _assert_gemm(ours, plain, x_eff, w_eff, plain_sum, res if requant else None)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES, ids=lambda v: str(v))
def test_fused_quant_matmul_matches_plain(cuda, rng, m, k, n):
    _check_fused_quant_matmul(cuda, rng, m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES, ids=lambda v: str(v))
def test_dequant_matmul_matches_plain(cuda, rng, m, k, n):
    """Every x form (bf16, f32 quantized on the load, f32, codes), with and
    without the res requant, f32 and bf16 out."""
    _check_dequant_matmul(cuda, rng, m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", LLAMA_GEMM_SHAPES, ids=lambda v: str(v))
def test_fused_quant_matmul_at_llama_widths(cuda, rng, m, k, n):
    """Both x forms of K2 at decode row counts and across the route
    threshold: route A equal to the plain version, route B its contract."""
    _check_fused_quant_matmul(cuda, rng, m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", LLAMA_GEMM_SHAPES, ids=lambda v: str(v))
def test_dequant_matmul_at_llama_widths(cuda, rng, m, k, n):
    """Every x form of K4 at decode row counts and across the route
    threshold."""
    _check_dequant_matmul(cuda, rng, m, k, n)


@pytest.mark.cuda
def test_gemm_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros((4, 8), device=cuda)
    w16 = torch.zeros((8, 3), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k2.fused_quant_matmul(x, w16.cpu())
    with pytest.raises(TypeError):
        k2.fused_quant_matmul(x, w16, out_dtype=torch.float16)
    codes = torch.zeros((8, 3), device=cuda, dtype=torch.uint8)
    with pytest.raises(TypeError):
        k4.dequant_matmul(x.double(), codes, torch.zeros(3, device=cuda), expo_width=3,
                          mant_width=4)
    with pytest.raises(TypeError):
        k2.quantize_block(x.double(), 1.0, 5, 4, 1)


# (M, K, N): Llama-3-8B's decode projections (k/v, gate/up, down) and a
# prefill chunk, odd K with M and N off any tile, a single column; both
# sides of the route edge (M = 16 / 17), every admission chunk of the
# serving run in chip_smoke.py (17, 100, 256, 511 and 64 tokens padded to
# 32, 112, 256, 512 and 64 rows), and odd K at Llama widths on both routes
INT4_SHAPES = [(4, 4096, 1024), (4, 4096, 14336), (4, 14336, 4096), (512, 4096, 14336),
               (9, 97, 136), (33, 255, 7), (1, 1, 1),
               (16, 4096, 4096), (17, 4096, 4096), (32, 4096, 1024), (64, 4096, 1024),
               (112, 4096, 1024), (256, 14336, 1024), (512, 4096, 1024),
               (3, 4097, 1000), (40, 4097, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", INT4_SHAPES)
def test_int4_matmul_matches_plain(cuda, rng, m, k, n):
    from fp8_quantization_tpu_torch.ops.fastpath import pack_int4

    x = torch.from_numpy(rng.integers(-128, 128, size=(m, k)).astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-8, 8, size=(k, n)).astype(np.int8)).to(cuda)
    x[0, :] = -128
    w[:, 0] = -8     # the largest products
    w4 = pack_int4(w)
    before = k4.int4_matmul.launches
    ours = k4.int4_matmul(x, w4, k=k)
    torch.cuda.synchronize()
    assert k4.int4_matmul.launches == before + 1 and ours.dtype == torch.int32
    assert torch.equal(ours, k4.int4_matmul_plain(x, w4, k=k))
    if m * k * n < 10 ** 7:
        want = (x.cpu().to(torch.int64) @ w.cpu().to(torch.int64)).to(torch.int32)
        assert torch.equal(ours.cpu(), want)


@pytest.mark.cuda
def test_int4_matmul_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.int8, device=cuda)
    w4 = torch.zeros((4, 3), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        k4.int4_matmul(x, w4.cpu(), k=8)
    with pytest.raises(TypeError):
        k4.int4_matmul(x.to(torch.int32), w4, k=8)
    with pytest.raises(ValueError):
        k4.int4_matmul(x, w4, k=7)


def _assert_sdpa(ours, q, k, v, **kw):
    ok, info = k7.within_sdpa_contract(ours, q, k, v, **kw)
    print(f"K7 {tuple(q.shape)} over {tuple(k.shape)} {sorted(kw)} {ours.dtype}: {info}")
    assert ok, info


def _assert_decode(ours, plain, name):
    equal = int((ours == plain).sum())
    print(f"K6 {name}: {equal} of {ours.numel()} outputs equal to plain, max|d| "
          f"{float((ours - plain).abs().max()):.3g}")
    assert torch.equal(ours, plain)


# (B, T, S, H, HK, D, keyword arguments): Llama-3-8B's cold prefill chunks
# (T = 17, 112 and 511) and a warm slab with offsets, ViT-B/16's attention,
# unaligned shapes
SDPA_SHAPES = {
    "llama_chunk": (1, 112, 112, 32, 8, 128, dict(causal=True)),
    "llama_chunk_t17": (1, 17, 17, 32, 8, 128, dict(causal=True)),
    "llama_chunk_t511": (1, 511, 511, 32, 8, 128, dict(causal=True)),
    "llama_slab_offsets": (2, 16, 300, 32, 8, 128, dict(causal=True, offsets=[100, 284])),
    "vit": (2, 197, 197, 12, 12, 64, dict(s_valid=197)),
    "unaligned": (2, 37, 53, 6, 2, 40, dict(s_valid=45)),
    "unaligned_causal": (3, 70, 70, 4, 1, 24, dict(causal=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SDPA_SHAPES))
def test_fused_sdpa_matches_plain(cuda, rng, name):
    b, t, s, h, hk, d, kw = SDPA_SHAPES[name]
    q = torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.normal(size=(b, s, hk, d)).astype(np.float32)).to(cuda)
            for _ in range(2))
    if "offsets" in kw:
        kw = {**kw, "offsets": torch.tensor(kw["offsets"], dtype=torch.int32, device=cuda)}
    for out_dtype in (torch.float32, torch.bfloat16):
        before = k7.fused_sdpa.launches
        ours = k7.fused_sdpa(q, k, v, out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        assert k7.fused_sdpa.launches == before + 1 and ours.dtype == out_dtype
        _assert_sdpa(ours, q, k, v, **kw)
    res = (torch.tensor(2.0, device=cuda), torch.tensor(5, device=cuda), 4, 1)
    ctx = k7.fused_sdpa(q, k, v, **kw)
    requant = k7.fused_sdpa(q, k, v, res_params=res, **kw)
    assert torch.equal(requant, k2.quantize_block_plain(ctx, *res))
    _assert_sdpa(requant, q, k, v, res_params=res, **kw)


# (B, S, H, HK, D, lengths): Llama-3-8B's decode over a 2048-slot slab, its
# lengths on the 64-key sub-chunk and 512-key block edges, an S that is not a
# multiple of the 512-key block, and a slot of length 0
DECODE_SHAPES = {
    "llama": (4, 2048, 32, 8, 128, [1, 100, 1000, 2048]),
    "llama_edges": (7, 640, 32, 8, 128, [1, 63, 64, 65, 511, 512, 513]),
    "s_not_a_block_multiple": (3, 700, 8, 2, 64, [1, 513, 700]),
    "empty_slot": (2, 40, 4, 4, 24, [0, 17]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("coded", [False, True], ids=["bf16", "codes"])
@pytest.mark.parametrize("name", list(DECODE_SHAPES))
def test_decode_attention_matches_plain(cuda, rng, name, coded):
    b, s, h, hk, d, lengths = DECODE_SHAPES[name]
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32)).to(cuda)
    kf, vf = (torch.from_numpy(rng.normal(size=(b, s, hk, d)).astype(np.float32)).to(cuda)
              for _ in range(2))
    if coded:
        kw = dict(k_bias=torch.tensor(4, dtype=torch.int32, device=cuda),
                  v_bias=torch.tensor(5, dtype=torch.int32, device=cuda), kv_expo=3, kv_mant=4)
        k_slab = pack_exmy(kf, 3, 4, kw["k_bias"], clip_of=True)
        v_slab = pack_exmy(vf, 3, 4, kw["v_bias"], clip_of=True)
    else:
        kw, k_slab, v_slab = {}, kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = k6.decode_attention.launches
    ours = k6.decode_attention(q, k_slab, v_slab, lens, **kw)
    torch.cuda.synchronize()
    assert k6.decode_attention.launches == before + 1 and ours.dtype == torch.float32
    _assert_decode(ours, k6.decode_attention_plain(q, k_slab, v_slab, lens, **kw),
                   f"{name} {'codes' if coded else 'bf16'} lengths {lengths}")


@pytest.mark.cuda
def test_attention_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 4, 2, 512), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        k7.fused_sdpa(q, q, q)
    with pytest.raises(ValueError):
        k7.fused_sdpa(q[..., :8], q[..., :8].cpu(), q[..., :8])
    slab = torch.zeros((1, 8, 2, 8), device=cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        k6.decode_attention(torch.zeros((1, 2, 8), device=cuda), slab, slab, one)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros((1, 8, 2, 512), device=cuda, dtype=torch.bfloat16)
        k6.decode_attention(torch.zeros((1, 2, 512), device=cuda), wide, wide, one)
    with pytest.raises(ValueError, match="key block"):
        long = torch.zeros((1, 2048, 2, 8), device=cuda, dtype=torch.bfloat16)
        k6.decode_attention(torch.zeros((1, 2, 8), device=cuda), long, long, one, bs=1024)


# the int8 conv's distinct shapes in MobileNetV2 and ResNet-18, on small
# inputs: (kernel, stride, pad, in, out, groups): the stems, a strided and a
# depthwise 3x3, the 1x1 downsample, a 1x1 with K off a multiple of 8, g = 2
INT8_CONVS = [(3, 2, 1, 3, 32, 1), (7, 2, 3, 3, 64, 1), (3, 1, 1, 64, 64, 1),
              (3, 2, 1, 64, 128, 1), (3, 1, 1, 96, 96, 96), (3, 2, 1, 144, 144, 144),
              (1, 2, 0, 64, 128, 1), (1, 1, 0, 20, 24, 1), (3, 1, 1, 8, 12, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,pad,cin,cout,g", INT8_CONVS, ids=lambda v: str(v))
def test_int8_conv_sums_match_cpu(cuda, rng, k, stride, pad, cin, cout, g):
    """The int8 conv of uniform conv serving (``fastpath.int8_conv_sums``:
    ``torch._int_mm`` on im2col codes, or the int32 tap sums of grouped
    convs) on the card equals the CPU int32 path and a float64 convolution
    of the codes, sums and zero-point window sums alike, with the padding
    filled by the zero point's code 0 or -128."""
    import torch.nn.functional as F

    from fp8_quantization_tpu_torch.ops.fastpath import int8_conv_sums

    x = torch.from_numpy(rng.integers(-128, 128, size=(2, 11, 11, cin)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, size=(k, k, cin // g, cout)).astype(np.int8))
    for cx in (0.0, -128.0):
        kw = dict(strides=(stride, stride), padding=[(pad, pad)] * 2, dilation=(1, 1),
                  groups=g, with_xsum=True)
        acc, xsum = int8_conv_sums(x.to(cuda), w.to(cuda), torch.tensor(cx, device=cuda), **kw)
        cpu_acc, cpu_xsum = int8_conv_sums(x, w, torch.tensor(cx), **kw)
        assert acc.dtype == torch.int32 and torch.equal(acc.cpu(), cpu_acc)
        assert torch.equal(xsum.cpu(), cpu_xsum)
        xp = F.pad(x.permute(0, 3, 1, 2).double(), (pad,) * 4, value=cx)
        want = F.conv2d(xp, w.permute(3, 2, 0, 1).double(), stride=stride, groups=g)
        assert torch.equal(cpu_acc.double(), want.permute(0, 2, 3, 1))


def _llama_qc():
    """``scripts/bench_llama.py``'s FP8 configuration."""
    from fp8_quantization_tpu_torch import config as tc

    return tc.QuantConfig(
        method=tc.QMethod.fp_quantizer, per_channel_weights=True, quantize_input=True,
        weight_range=tc.EstimatorConfig(tc.RangeMethod.current_minmax),
        act_range=tc.EstimatorConfig(tc.RangeMethod.allminmax),
        fp8=tc.FP8Config(set_maxval=True, mse_include_mantissa_bits=False),
        run_method=tc.RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True))


@pytest.mark.cuda
def test_warm_admission_and_verify_through_the_kernels(cuda, monkeypatch):
    """A small Llama under FAST+fused with a ``PrefixCache`` and a
    self-draft, 4 slots: a warm admission (a 48-token prefix spliced, a
    24-token tail prefilled as 32 rows over the slab) and one speculative
    round (a 20-row verify). Every K7 call with offsets and every K2 call
    on route B is held to its plain version's contract on its own inputs."""
    from fp8_quantization_tpu_torch.models.llama import LlamaSpec, QuantizedLlama
    from fp8_quantization_tpu_torch.models.prefix_cache import PrefixCache
    from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher, calibrate_llama
    from fp8_quantization_tpu_torch.quant.sites import QuantPhase

    spec = LlamaSpec(vocab_size=1024, hidden_size=512, num_layers=2, num_heads=8,
                     num_kv_heads=2, mlp_dim=1024, max_seq_len=256)
    model = QuantizedLlama(_llama_qc(), spec, device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    gen = np.random.default_rng(3)
    calibrate_llama(model, gen.integers(0, spec.vocab_size, (2, 16)))
    held = {"K7 offsets": [], "K2 route B": []}
    sdpa, gemm = k7.fused_sdpa, k2.fused_quant_matmul

    def sdpa_call(q, k, v, **kw):
        monkeypatch.setattr(k7, "fused_sdpa", sdpa)       # the wrapper counts under its name
        ours = sdpa(q, k, v, **kw)
        monkeypatch.setattr(k7, "fused_sdpa", sdpa_call)
        if kw.get("offsets") is not None:
            _assert_sdpa(ours, q, k, v, **kw)
            held["K7 offsets"].append(tuple(q.shape))
        return ours

    def gemm_call(x, w, act=None, **kw):
        monkeypatch.setattr(k2, "fused_quant_matmul", gemm)
        ours = gemm(x, w, act, **kw)
        monkeypatch.setattr(k2, "fused_quant_matmul", gemm_call)
        if k2.gemm_route(x.shape[0]) == "B":
            x_eff = k2.quantize_block_plain(x, *act) if kw.get("quantize_x", True) else x
            plain = k2.fused_quant_matmul_plain(x, w, act, **kw)
            _assert_gemm(ours, plain, x_eff.to(torch.bfloat16).float(), w.float(), plain)
            held["K2 route B"].append(tuple(x.shape))
        return ours

    sdpa_call.launches = gemm_call.launches = 0
    first = gen.integers(0, spec.vocab_size, 50).tolist()
    second = first[:48] + gen.integers(0, spec.vocab_size, 24).tolist()
    pc = PrefixCache()
    batcher = ContinuousBatcher(model, spec, slots=4, qp=QuantPhase(phase="fixed", fast=True,
                                                                   fused_sdpa=True),
                                prefix_cache=pc, draft_model=model, draft_spec=spec, spec_k=4)
    batcher.admit(first, max_new_tokens=8)
    monkeypatch.setattr(k7, "fused_sdpa", sdpa_call)
    monkeypatch.setattr(k2, "fused_quant_matmul", gemm_call)
    batcher.admit(second, max_new_tokens=8)
    warm = {key: list(calls) for key, calls in held.items()}
    assert batcher.step() and pc.hits == 1
    torch.cuda.synchronize()
    print(f"held on their own inputs: {held}")
    # the warm admission: K7 over the slab from 48, K2 at 32 rows (the draft's
    # cold prefill of all 72 tokens is a chunk, without offsets)
    assert warm["K7 offsets"] == [(1, 32, 8, 64)] * spec.num_layers
    assert (32, spec.hidden_size) in warm["K2 route B"]
    # the verify: 4 slots x 5 tokens
    assert held["K7 offsets"][-spec.num_layers:] == [(4, 5, 8, 64)] * spec.num_layers
    assert (20, spec.hidden_size) in held["K2 route B"]
