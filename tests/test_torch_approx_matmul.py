"""K3, the approximate-multiplier GEMM: the port's plain version against the
JAX package's Pallas kernel (interpret mode on the CPU, as
``tests/test_approx_pallas.py`` runs it) and its jnp oracle, at the Pallas
tests' tolerance ``rtol=atol=1e-6`` (summation order over K differs).

The CUDA kernel itself runs only on a GPU: ``tests/test_torch_cuda.py`` holds
it against this plain version on the same flag cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.numerics import approx_matmul_golden as j_golden
from fp8_quantization_tpu.numerics.luts import get_error_table as j_table
from fp8_quantization_tpu.ops.pallas.approx_matmul import approx_matmul_pallas
from fp8_quantization_tpu_torch.numerics.approx_matmul import (
    approx_matmul_golden,
    approx_products,
)
from fp8_quantization_tpu_torch.numerics import codec
from fp8_quantization_tpu_torch.numerics.luts import get_error_table
from fp8_quantization_tpu_torch.ops.cuda import approx_matmul as k3
from test_torch_cuda import CASES, case_id, grid_operands

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

TOL = dict(rtol=1e-6, atol=1e-6)

# jitted: op-by-op dispatch of the oracle compiles every primitive separately
_j_golden = jax.jit(j_golden, static_argnums=(2, 3), static_argnames=(
    "with_approx", "with_s2nn2s_opt", "quant_btw_mult_accu", "golden_clip_of"))


def _check(a, b, ba, bb, br, *, expo_width, mant_width, with_comp, **flags):
    ew, mw = expo_width, mant_width
    table = j_table(ew, mw, with_comp, 3)
    jax_golden = np.asarray(_j_golden(a, b, ew, mw, ba, bb, br, table, **flags))
    jax_kernel = np.asarray(approx_matmul_pallas(
        jnp.asarray(a), jnp.asarray(b), ba, jnp.asarray(bb), br, expo_width=ew,
        mant_width=mw, with_comp=with_comp, bm=8, bn=8, bk=8, **flags))
    ours = k3.approx_matmul(torch.tensor(a), torch.tensor(b), ba,
                            torch.as_tensor(bb), br, expo_width=ew, mant_width=mw,
                            with_comp=with_comp, **flags).numpy()
    np.testing.assert_allclose(ours, jax_golden, **TOL)
    np.testing.assert_allclose(ours, jax_kernel, **TOL)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_matches_jax(case, rng):
    a, b = grid_operands(rng, 24, 40, 16, case["expo_width"], case["mant_width"], 5, 6)
    _check(a, b, 5, 6, 4, **case)


def test_plain_per_column_bias(rng):
    ba, br = 5, 4
    bias_b = np.array([3, 4, 5, 6, 7, 8, 5, 6], dtype=np.int32)
    a, b = grid_operands(rng, 16, 24, 8, 3, 4, ba, bias_b)
    _check(a, b, ba, bias_b, br, expo_width=3, mant_width=4, with_comp=True)


def test_plain_unaligned_shapes(rng):
    a, b = grid_operands(rng, 13, 17, 9, 3, 4, 5, 6)
    _check(a, b, 5, 6, 4, expo_width=3, mant_width=4, with_comp=True)


@pytest.mark.parametrize("s2", [False, True], ids=["golden_fallback", "s2nn2s"])
@pytest.mark.parametrize("ba,br", [(np.inf, np.inf), (np.inf, 4.0), (5.0, np.inf)])
def test_plain_zero_operand_with_degenerate_bias(rng, s2, ba, br):
    """A site that saw only zeros (the init forward of a zeros batch) has
    maxval 0 and bias +inf: its zero operand gives zero products in JAX's
    oracle and kernel and in the port, whose biases saturate as XLA's do."""
    a = np.zeros((5, 8), np.float32)
    b = (np.round(rng.normal(size=(8, 3)) * 16) / 16).astype(np.float32)
    bb = np.array([6.0, 7.0, 8.0], np.float32)
    flags = dict(with_approx=True, with_s2nn2s_opt=s2)
    table = j_table(3, 4, True, 3)
    jax_golden = np.asarray(_j_golden(
        a, b, 3, 4, jnp.float32(ba).astype(jnp.int32), jnp.asarray(bb).astype(jnp.int32),
        jnp.float32(br).astype(jnp.int32), table, **flags))
    jax_kernel = np.asarray(approx_matmul_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.float32(ba), jnp.asarray(bb), jnp.float32(br),
        expo_width=3, mant_width=4, with_comp=True, **flags))
    ours = k3.approx_matmul(torch.from_numpy(a), torch.from_numpy(b), torch.tensor(ba),
                            torch.from_numpy(bb), torch.tensor(br), expo_width=3,
                            mant_width=4, with_comp=True, **flags).numpy()
    np.testing.assert_array_equal(ours, jax_golden)
    np.testing.assert_array_equal(ours, jax_kernel)
    np.testing.assert_array_equal(ours, np.zeros((5, 3), np.float32))


def test_plain_row_blocks_and_terms(rng):
    """The wrapper's plain version runs in row blocks and equals one call of
    the oracle; the per-product terms sum to it."""
    a, b = grid_operands(rng, 2 * k3.PLAIN_ROWS + 3, 12, 5, 3, 4, 5, 6)
    table = get_error_table(3, 4, True, 3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    whole = approx_matmul_golden(ta, tb, 3, 4, 5, 6, 4, table)
    blocked = k3.approx_matmul_plain(ta, tb, 5, 6, 4, expo_width=3, mant_width=4,
                                     with_comp=True)
    np.testing.assert_array_equal(blocked.numpy(), whole.numpy())
    terms = approx_products(ta, tb, 3, 4, 5, 6, 4, table)
    np.testing.assert_array_equal(terms.sum(dim=1).numpy(), whole.numpy())


def test_cpu_tensor_takes_plain_version(rng):
    a, b = grid_operands(rng, 4, 8, 3, 3, 4, 5, 6)
    before = k3.approx_matmul.launches
    k3.approx_matmul(torch.from_numpy(a), torch.from_numpy(b), 5, 6, 4,
                     expo_width=3, mant_width=4, with_comp=True)
    assert k3.approx_matmul.launches == before


def test_unported_modes_raise():
    """Around the approximate path everything is ported now: the mesh flags
    make a mesh of the visible devices (the CPU's one device cannot hold a
    (2, 1) mesh, which raises as the JAX package's ``make_mesh`` does) and
    a ring-attention prefill is a setting of the Llama blocks (the
    oracle-only modes run: the cases below). LSQ gradient scaling is ported
    with QAT: a phase carries it, and QAT refuses the approximate
    multiplier, which has no gradient."""
    from fp8_quantization_tpu_torch import cli as tcli
    from fp8_quantization_tpu_torch import config as tc
    from fp8_quantization_tpu_torch.models.llama import LLAMA_TINY, QuantLlamaBlock
    from fp8_quantization_tpu_torch.parallel import make_mesh
    from fp8_quantization_tpu_torch.quant.sites import QuantPhase

    args = tcli.build_parser().parse_args(
        ["validate-quantized", "--architecture", "vit_quantized", "--mesh-data", "2"])
    assert (args.mesh_data, args.mesh_model) == (2, 1)
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        make_mesh(data=args.mesh_data, model=args.mesh_model, devices="cpu")
    mesh = make_mesh(data=2, devices=[torch.device("cpu")] * 2)
    assert QuantLlamaBlock(tc.QuantConfig(), LLAMA_TINY,
                           ring_spec=(mesh, "data")).ring_spec == (mesh, "data")
    assert QuantPhase(grad_scaling=True).grad_scaling
    from fp8_quantization_tpu_torch.models.demo import QuantizedDemoModel
    from fp8_quantization_tpu_torch.quant import qat

    approx = tc.QuantConfig(quantize_input=True, run_method=tc.RunMethodConfig(
        res_quantizer_flag=True, approx_flag=True))
    model = QuantizedDemoModel(approx)
    with pytest.raises(ValueError, match="approximate multiplier"):
        qat.make_qat_step(model, qat.make_optimizer(), grad_scaling=True)[1](model)


_j_golden_full = jax.jit(j_golden, static_argnums=(2, 3), static_argnames=(
    "with_approx", "with_s2nn2s_opt", "sim_hw_add_ofuf", "with_of_opt", "with_uf_opt",
    "quant_btw_mult_accu", "golden_clip_of", "self_check"))
OFUF = [(False, False), (True, False), (False, True), (True, True)]


def _wide_operands(rng, m, k, n, ba, bias_b):
    """Grid operands over many binades, so the adder overflows and
    underflows: E3M4 values of magnitude 2^-5 .. 2^4."""
    scale_a = np.exp2(rng.integers(-5, 5, size=(m, k)))
    scale_b = np.exp2(rng.integers(-5, 5, size=(k, n)))
    a, b = grid_operands(rng, m, k, n, 3, 4, ba, bias_b)
    a = codec.quantize_exmy(torch.from_numpy((a * scale_a).astype(np.float32)), 3, 4, ba)
    b = codec.quantize_exmy(torch.from_numpy((b * scale_b).astype(np.float32)), 3, 4,
                            torch.as_tensor(np.asarray(bias_b)).reshape(1, -1))
    return a.numpy(), b.numpy()


@pytest.mark.parametrize("of,uf", OFUF, ids=["plain", "of", "uf", "of_uf"])
def test_sim_hw_add_ofuf_matches_jax(rng, of, uf):
    """The integer-domain OF/UF adder against the JAX oracle, with the
    golden fallback and under s2nn2s (the oracle's raw zero mask): every
    product bit for bit (one K = 1 call pairs each element of ``a`` with
    each of ``b``: where the sum is the product), the sums over K = 16
    within the Pallas tests' tolerance of JAX's products summed (the oracle
    sums its elementwise products over K); the fix-ups change the result
    (the underflow one only under s2nn2s: elsewhere an underflowing product
    is subnormal and takes the golden value)."""
    ba, br = 5, 4
    m, k, n = 12, 16, 6
    bias_b = np.array([3, 4, 5, 6, 7, 8], dtype=np.int32)
    a, b = _wide_operands(rng, m, k, n, ba, bias_b)
    table = get_error_table(3, 4, True, 3)
    ta, tb, tbb = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(bias_b)
    # row (i, kk) of a_col and column (kk2, j) of b_row: a[i, kk] * b[kk2, j]
    a_col, b_row, bias_row = a.reshape(-1, 1), b.reshape(1, -1), np.tile(bias_b, k)
    for s2 in (False, True):
        kw = dict(sim_hw_add_ofuf=True, with_of_opt=of, with_uf_opt=uf, with_s2nn2s_opt=s2)
        products = np.asarray(_j_golden_full(a_col, b_row, 3, 4, ba, bias_row, br,
                                             j_table(3, 4, True, 3), **kw))
        ours = approx_matmul_golden(torch.from_numpy(a_col), torch.from_numpy(b_row), 3, 4,
                                    ba, torch.from_numpy(bias_row), br, table,
                                    zero_mask="raw", **kw).numpy()
        np.testing.assert_array_equal(ours, products)
        pairs = products.reshape(m, k, k, n)[:, np.arange(k), np.arange(k), :]
        ours = approx_matmul_golden(ta, tb, 3, 4, ba, tbb, br, table, zero_mask="raw",
                                    **kw).numpy()
        np.testing.assert_allclose(ours, pairs.astype(np.float64).sum(axis=1), **TOL)
        plain = approx_matmul_golden(ta, tb, 3, 4, ba, tbb, br, table, zero_mask="raw",
                                     sim_hw_add_ofuf=True, with_s2nn2s_opt=s2)
        if of or (uf and s2):
            assert not np.array_equal(ours, plain.numpy())
    float_domain = approx_matmul_golden(ta, tb, 3, 4, ba, tbb, br, table)
    assert not torch.equal(approx_matmul_golden(ta, tb, 3, 4, ba, tbb, br, table,
                                                sim_hw_add_ofuf=True), float_domain)


@pytest.mark.parametrize("s2", [False, True], ids=["golden_fallback", "s2nn2s"])
def test_self_check_stats_match_jax(rng, s2):
    """``self_check``'s ApproxStats: the operands' and products' normal
    shares and the error against the golden sum."""
    ba, bb, br = 5, 6, 4
    a, b = _wide_operands(rng, 10, 12, 7, ba, bb)
    want, jstats = _j_golden_full(a, b, 3, 4, ba, bb, br, j_table(3, 4, True, 3),
                                  with_s2nn2s_opt=s2, self_check=True)
    ours, stats = approx_matmul_golden(torch.from_numpy(a), torch.from_numpy(b), 3, 4, ba,
                                       bb, br, get_error_table(3, 4, True, 3),
                                       with_s2nn2s_opt=s2, self_check=True, zero_mask="raw")
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), **TOL)
    assert stats._fields == jstats._fields
    for name, t, j in zip(stats._fields, stats, jstats):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name, **TOL)
    assert 0 < float(stats.norm_frac_a) < 1 and (float(stats.norm_frac_r) == 1.0) == s2


@pytest.mark.parametrize("per_column", [False, True], ids=["scalar_bias", "per_column_bias"])
def test_golden_v6_matches_jax(rng, per_column):
    """The v6 integer-domain oracle (all-normal codec, flat-code adder,
    final requant) at the JAX package's own tolerance against the
    reference, with its self-check statistics."""
    from fp8_quantization_tpu.numerics import approx_matmul_golden_v6 as j_v6
    from fp8_quantization_tpu.numerics import quantize_exmy_allnorm as j_allnorm
    from fp8_quantization_tpu_torch.numerics import approx_matmul_golden_v6

    ba = 5
    bias_b = np.array([3, 4, 5, 6, 7], dtype=np.int32) if per_column else np.int32(6)
    bias_r = np.array([4, 5, 3, 6, 4], dtype=np.int32) if per_column else np.int32(4)
    a = np.array(j_allnorm((rng.normal(size=(12, 8)) * 2).astype(np.float32), 3, 4, ba))
    b = np.array(j_allnorm((rng.normal(size=(8, 5)) * 2).astype(np.float32), 3, 4,
                             np.asarray(bias_b).reshape(1, -1) if per_column else bias_b))
    want, jstats = jax.jit(j_v6, static_argnums=(2, 3), static_argnames=("self_check",))(
        a, b, 3, 4, ba, bias_b, bias_r, j_table(3, 4, True, 3), self_check=True)
    ours, stats = approx_matmul_golden_v6(torch.from_numpy(a), torch.from_numpy(b), 3, 4, ba,
                                          torch.as_tensor(bias_b), torch.as_tensor(bias_r),
                                          get_error_table(3, 4, True, 3), self_check=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), **TOL)
    for name, t, j in zip(stats._fields, stats, jstats):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name, **TOL)
    plain = approx_matmul_golden_v6(torch.from_numpy(a), torch.from_numpy(b), 3, 4, ba,
                                    torch.as_tensor(bias_b), torch.as_tensor(bias_r),
                                    get_error_table(3, 4, True, 3))
    np.testing.assert_array_equal(plain.numpy(), ours.numpy())


@pytest.mark.parametrize("mode", ["sim_hw_add_ofuf", "debug_mode", "self_check_mode"])
def test_oracle_only_modes_take_the_oracle(rng, mode, monkeypatch):
    """A layer's approximate product under a mode only the oracle simulates
    goes to ``approx_matmul_oracle`` (the JAX package's jnp oracle, as its
    dispatch does), never to K3, and equals the oracle run by hand."""
    from fp8_quantization_tpu_torch import config as tc
    from fp8_quantization_tpu_torch.ops import layers as tlayers

    approx = tc.ApproxConfig(with_comp=True, with_approx=True, with_of_opt=True,
                             **{mode: True})
    a, b = grid_operands(rng, 6, 16, 5, 3, 4, 5, 6)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    calls = []
    real = tlayers.approx_matmul_oracle
    monkeypatch.setattr(tlayers, "approx_matmul_oracle",
                        lambda *args: calls.append(1) or real(*args))
    before = k3.approx_matmul.launches
    bias_b = torch.full((5,), 6, dtype=torch.int32)
    got = tlayers.approx_matmul_2d(ta, tb, torch.tensor(5), bias_b, torch.tensor(4), approx)
    assert calls == [1] and k3.approx_matmul.launches == before
    want = approx_matmul_golden(ta, tb, 3, 4, 5, bias_b, 4, get_error_table(3, 4, True, 3),
                                sim_hw_add_ofuf=approx.sim_hw_add_ofuf, with_of_opt=True,
                                zero_mask="raw")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_library_name_tracks_source_and_flags(monkeypatch, tmp_path):
    """A changed source or flag set builds a new library, never reuses one."""
    from fp8_quantization_tpu_torch.ops.cuda import build

    src = tmp_path / "approx_matmul.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    p1 = build.library_path("approx_matmul")
    src.write_text("// v2\n")
    p2 = build.library_path("approx_matmul")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    p3 = build.library_path("approx_matmul")
    assert len({p1, p2, p3}) == 3
    assert "-fmad=false" in build.NVCC_FLAGS and "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_sass_mix_counts_the_widest_loop():
    """The SASS reader behind K3's instruction bound: it takes the flagship
    instantiation, finds the widest backward branch and classes what it
    spans."""
    import collections

    from fp8_quantization_tpu_torch.ops.cuda import sass_mix

    sass = """
        Function : _ZN12_GLOBAL__N_120approx_matmul_kernelILb1ELb1ELb0ELb0EEEvPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;       /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;           /* 0x0000000000007919 */
        /*0020*/              @P0  FMUL R2, R3, R4 ;            /* 0x0000000403027220 */
        /*0030*/                   IADD3 R5, R5, 0x1, RZ ;      /* 0x0000000105057810 */
        /*0040*/                   LDS R6, [R7] ;               /* 0x0000000007067984 */
        /*0050*/              @!P1 BRA 0x20 ;                   /* 0xfffffffc00b49947 */
        /*0060*/                   EXIT ;                       /* 0x000000000000794d */
        Function : _ZN12_GLOBAL__N_120approx_matmul_kernelILb0ELb1ELb0ELb0EEEvPKf
        /*0000*/                   EXIT ;                       /* 0x000000000000794d */
    """
    funcs = sass_mix._functions(sass)
    assert len(funcs) == 2
    (name, instrs), = [(k, v) for k, v in funcs.items() if sass_mix.FLAGSHIP in k]
    assert [op for _, op, _ in instrs] == ["LDC", "S2R", "FMUL", "IADD3", "LDS", "BRA", "EXIT"]
    n, mix = sass_mix.loop_mix(instrs)
    assert n == 4
    assert mix == collections.Counter(fp32=1, int=1, shared_load=1, control=1)


S2NN2S_BIAS_A = (2, 5, 8)
S2NN2S_BIAS_B = (3, 7)
S2NN2S_BIAS_R = (-6, 0, 6, 15)


@pytest.mark.parametrize("expo,mant", [(3, 4), (4, 3), (2, 5)])
def test_s2nn2s_zero_mask_on_every_single_product(expo, mant):
    """The s2nn2s zero mask on every single product (K = 1) of the format's
    signed value space, against a weight row holding the value space on each
    of ``S2NN2S_BIAS_B``'s grids (a per-column bias), for each ``bias_a`` and
    ``bias_r``, with ``with_s2nn2s_opt`` and ``quant_btw_mult_accu`` on.

    JAX's jnp oracle zeroes a product whose raw value is 0; its Pallas
    kernel, which the JAX CLI runs, one whose requantized golden is 0. On
    E3M4 and E4M3 the two agree on every such product; on E2M5 they do not
    (a nonzero product that rounds to zero on a low-``bias_r`` result grid,
    such as 1.03125 * 1.9375 under ``bias_r = -6``). The port's
    ``approx_matmul_golden`` takes the mask as an argument: with
    ``zero_mask="raw"`` (the grouped and depthwise approx convs' oracle) it
    equals the jnp oracle on every product; with ``"requantized"`` (the
    default) it and K3 (plain version here, the CUDA kernel on the card)
    equal the Pallas kernel on every product."""
    flags = dict(with_approx=True, with_s2nn2s_opt=True, quant_btw_mult_accu=True)
    table = j_table(expo, mant, True, 3)

    def signed_space(bias):
        vs = codec.value_space(expo, mant, bias)
        return torch.cat([vs, -vs[1:]])

    b = torch.cat([signed_space(bb) for bb in S2NN2S_BIAS_B]).reshape(1, -1)
    bias_b = np.repeat(np.array(S2NN2S_BIAS_B, np.int32), b.shape[1] // len(S2NN2S_BIAS_B))
    disagree = 0
    for ba in S2NN2S_BIAS_A:
        a = signed_space(ba).reshape(-1, 1)
        for br in S2NN2S_BIAS_R:
            ours = k3.approx_matmul(a, b, ba, torch.from_numpy(bias_b), br,
                                    expo_width=expo, mant_width=mant, with_comp=True,
                                    **flags).numpy()
            golden = approx_matmul_golden(a, b, expo, mant, ba, torch.from_numpy(bias_b), br,
                                          get_error_table(expo, mant, True, 3),
                                          **flags).numpy()
            jax_golden = np.asarray(_j_golden(a.numpy(), b.numpy(), expo, mant, ba, bias_b,
                                              br, table, **flags))
            jax_kernel = np.asarray(approx_matmul_pallas(
                jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), ba, jnp.asarray(bias_b), br,
                expo_width=expo, mant_width=mant, with_comp=True, **flags))
            np.testing.assert_array_equal(ours, jax_kernel, err_msg=f"{ba} {br}")
            np.testing.assert_array_equal(golden, jax_kernel, err_msg=f"{ba} {br}")
            raw = approx_matmul_golden(a, b, expo, mant, ba, torch.from_numpy(bias_b), br,
                                       get_error_table(expo, mant, True, 3),
                                       zero_mask="raw", **flags).numpy()
            np.testing.assert_array_equal(raw, jax_golden, err_msg=f"{ba} {br}")
            disagree += int((jax_kernel != jax_golden).sum())
    # the two JAX functions disagree only where the grid is low enough
    assert (disagree > 0) == ((expo, mant) == (2, 5))
