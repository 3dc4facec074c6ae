"""The port's range estimators against the JAX package's, on the same numpy
inputs: the FP8 MSE search with its mantissa-width election, the
cross-entropy search, percentile ranges and the line search; a QuantSite
under MSE through ESTIMATE -> FIXED (and FAST, through K1's plain version at
the elected width); and the one place the port departs on purpose, the
zeros init forward.

Tolerances and the election rule:

* per-candidate MSEs and cross-entropies: ``rtol=1e-6`` (the two frameworks
  sum in other orders);
* the MSE search grid: bit-equal per channel. Per tensor (C = 1) XLA's CPU
  ``linspace`` rounds some entries another way than any formula the port
  found, so there each entry is held to 2 ulps;
* the election: the same mantissa width; where the grids are bit-equal the
  same ``maxval``; everywhere, each channel's ``maxval`` is within 1 ulp of
  the JAX grid entry at the port's candidate index, and the JAX MSE there is
  within a relative 1e-6 of the JAX minimum at that width (an argmin may
  flip at a near-tie);
* percentiles: ``rtol=1e-6`` (per channel they agree bit for bit; per tensor
  XLA's interpolation rounds once more or less);
* line-search thresholds: equal up to ``rtol=1e-6``; the cross-entropy
  threshold by the election rule (the JAX loss at the port's candidate
  within a relative 1e-6 of the JAX minimum).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.numerics import fp8_ste as j_fp8_ste
from fp8_quantization_tpu.quant import estimators as je
from fp8_quantization_tpu.quant import quantizers as j_quantizers
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.numerics.fp8_ste import (quantize_to_fp8_ste,
                                                         quantize_to_fp8_widths)
from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as k1
from fp8_quantization_tpu_torch.quant import estimators as te
from fp8_quantization_tpu_torch.quant import sites as tsites

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

RTOL = 1e-6

# jitted: op-by-op dispatch compiles every primitive of the searches apart
_j_update = jax.jit(je.update, static_argnums=(0, 1, 4, 5))
_j_line_search = jax.jit(je.line_search_ranges, static_argnums=(1, 2),
                         static_argnames=("opt_method",))


def jit_jax_quantizer(mp):
    """Has the JAX package's searches and sites call its
    ``quantize_to_fp8_ste`` jitted (the function unchanged, its results bit
    for bit the same): an MSE search calls it at every width of every site,
    and tracing each call anew is most of a compile's time."""
    jitted = jax.jit(j_fp8_ste.quantize_to_fp8_ste, static_argnums=(1,))
    mp.setattr(je, "quantize_to_fp8_ste", jitted)
    mp.setattr(j_quantizers, "quantize_to_fp8_ste", jitted)


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_quantizer():
    with pytest.MonkeyPatch.context() as mp:
        jit_jax_quantizer(mp)
        yield


def _qcfg(mod, per_channel=False, elect=True, unsigned=False):
    return mod.QuantizerConfig(per_channel=per_channel, fp8=mod.FP8Config(
        set_maxval=True, mse_include_mantissa_bits=elect, allow_unsigned=unsigned))


def _ulps(a, b):
    """|a - b| in units of the last place of b (f32)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b))


def hold_election(jstate, jranges, tstate, tranges, rtol=RTOL, atol=0.0, grid_tol=None):
    """The election rule of the module docstring; the port's maxval is the
    grid entry at its per-channel candidate index. MSEs are compared where
    the grid entries are bit-equal: a candidate 1 ulp apart can sit across
    a bias rounding edge and quantize another way. ``grid_tol`` (allclose
    keywords) replaces the ulp bounds on the grid where the site's inputs
    themselves differ (a whole model's)."""
    jgrid, tgrid = np.asarray(jstate["search_grid"]), tstate["search_grid"].numpy()
    jmses, tmses = np.asarray(jstate["mses"]), tstate["mses"].numpy()
    same = np.broadcast_to(tgrid == jgrid, tmses.shape)
    np.testing.assert_allclose(tmses[same], jmses[same], rtol=rtol, atol=atol)
    assert float(tranges[2][0]) == float(jranges[2][0])
    width = [float(m) for m in range(1, 8)].index(float(tranges[2][0])) \
        if tmses.shape[0] > 1 else 0
    c = tgrid.shape[1]
    t_idx = np.argmin(tmses[width], axis=0)
    np.testing.assert_array_equal(np.asarray(tranges[1]), tgrid[t_idx, np.arange(c)])
    if grid_tol is not None:
        np.testing.assert_allclose(tgrid, jgrid, **grid_tol)
    else:
        assert _ulps(tgrid[t_idx, np.arange(c)], jgrid[t_idx, np.arange(c)]).max() <= 1
    j_at = jmses[width][t_idx, np.arange(c)]
    assert np.all(j_at <= jmses[width].min(axis=0) * (1 + rtol) + atol)
    if np.array_equal(tgrid, jgrid):
        np.testing.assert_array_equal(np.asarray(tranges[1]), np.asarray(jranges[1]))
        if tranges[0] is not None:
            np.testing.assert_array_equal(np.asarray(tranges[0]), np.asarray(jranges[0]))
    elif grid_tol is None:
        assert _ulps(tgrid, jgrid).max() <= 2


@pytest.mark.parametrize("mbits", range(1, 8))
def test_candidate_quantizer_equals_plain(rng, mbits):
    """The MSE search's quantizer equals ``quantize_to_fp8_ste`` bit for
    bit, on zeros, subnormals, clip edges and NaN, signed and unsigned, on
    grids whose step leaves the normal floats (the plain fallback), and with
    its clip shared across widths (``mbits`` after another width)."""
    x = (rng.normal(size=(1, 5, 200)) * 3).astype(np.float32)
    x[0, 0, :6] = [0.0, -0.0, 1e-40, -1e-39, 3e-38, np.nan]
    mv = (np.abs(rng.normal(size=(9, 5, 1))) * 4 + 1e-3).astype(np.float32)
    mv[0, 0, 0], mv[1, 1, 0], mv[2, 2, 0] = x[0, 1].max(), 0.0, 1e-36
    tx = torch.from_numpy(x)
    for grids in (mv, mv[3:]):                  # with and without fallback grids
        tm = torch.from_numpy(grids)
        for sign in (0, 1):
            widths = [mbits % 7 + 1, mbits]
            for m, lean in zip(widths, quantize_to_fp8_widths(tx, 8, tm, widths,
                                                              torch.tensor(sign))):
                torch.testing.assert_close(lean, quantize_to_fp8_ste(tx, 8, tm, float(m),
                                                                     sign)[0],
                                           rtol=0, atol=0, equal_nan=True)


MSE_CASES = {
    # id: (shape, per_channel, channel_axis, elect, allow_unsigned, non-negative data)
    "tensor_2d": ((64, 16), False, -1, True, False, False),
    "channel_last_2d": ((64, 16), True, -1, True, False, False),
    "channel_first_2d": ((16, 64), True, 0, True, False, False),
    "conv_hwio": ((3, 3, 8, 16), True, -1, True, False, False),
    "conv_hwio_static_width": ((3, 3, 8, 16), True, -1, False, False, False),
    "unsigned_nonneg": ((64, 16), True, -1, True, True, True),
    "unsigned_signed_data": ((64, 16), False, -1, True, True, False),
}


@pytest.mark.parametrize("case", list(MSE_CASES))
def test_fp_mse_matches_jax(case):
    """Two batches through ``_fp_mse``: the grid comes from the first, the
    MSEs add up, the width is elected by plurality and each channel takes
    its best ``maxval`` at that width (the module docstring's rule)."""
    shape, per_channel, axis, elect, unsigned, nonneg = MSE_CASES[case]
    rng = np.random.default_rng(1)
    xs = [(rng.normal(size=shape) * s).astype(np.float32) for s in (1.0, 2.0)]
    if nonneg:
        xs = [np.abs(x) for x in xs]
    jq, tq = _qcfg(jc, per_channel, elect, unsigned), _qcfg(tc, per_channel, elect, unsigned)
    jcfg, tcfg = jc.EstimatorConfig(jc.RangeMethod.MSE), tc.EstimatorConfig(tc.RangeMethod.MSE)
    js = je.init(jcfg, jq, shape, per_channel, axis)
    ts = te.init(tcfg, tq, shape[axis] if per_channel else 1, per_channel=per_channel)
    for x in xs:
        js, jr = _j_update(jcfg, jq, js, jnp.asarray(x), per_channel, axis)
        ts, tr = te.update(tcfg, tq, ts, torch.from_numpy(x), per_channel, axis)
    assert int(ts["count"]) == 2
    assert ts["mses"].shape == tuple(js["mses"].shape)
    hold_election(js, jr, ts, tr)
    if unsigned and nonneg:
        assert float(tr[0].abs().max()) == 0.0          # sign_bits 0 from the data
    if not elect:
        assert float(tr[2][0]) == 4.0


@pytest.mark.parametrize("method", ["fp", "symmetric_uniform"])
def test_cross_entropy_matches_jax(method):
    """The logits search over two batches: the grid of the first batch,
    losses summed, the threshold of least loss."""
    rng = np.random.default_rng(2)
    xs = [(rng.normal(size=(4, 10)) * 3).astype(np.float32) for _ in range(2)]

    def q(mod):
        if method == "fp":
            return mod.QuantizerConfig(fp8=mod.FP8Config(set_maxval=True))
        return mod.QuantizerConfig(method=mod.QMethod.symmetric_uniform)

    jq, tq = q(jc), q(tc)
    jcfg = jc.EstimatorConfig(jc.RangeMethod.cross_entropy, num_candidates=48)
    tcfg = tc.EstimatorConfig(tc.RangeMethod.cross_entropy, num_candidates=48)
    js, ts = je.init(jcfg, jq, xs[0].shape, False), te.init(tcfg, tq, 1)
    for x in xs:
        js, jr = _j_update(jcfg, jq, js, jnp.asarray(x), False, 0)
        ts, tr = te.update(tcfg, tq, ts, torch.from_numpy(x), False)
    np.testing.assert_array_equal(ts["search_grid"].numpy(), np.asarray(js["search_grid"]))
    np.testing.assert_allclose(ts["losses"].numpy(), np.asarray(js["losses"]), rtol=RTOL)
    # the election rule: distinct thresholds can clip the logits alike, so
    # the losses tie and an argmin may flip between the frameworks
    jl, tl = np.asarray(js["losses"])[:, 0], ts["losses"].numpy()[:, 0]
    t_idx = int(np.argmin(tl))
    assert jl[t_idx] <= jl.min() * (1 + RTOL)
    np.testing.assert_array_equal(tr[1].numpy(), ts["search_grid"].numpy()[t_idx])
    np.testing.assert_array_equal(tr[0].numpy(), -tr[1].numpy())
    assert tr[2] is None
    with pytest.raises(ValueError, match="per-tensor"):
        te.init(tcfg, tq, 4, per_channel=True)


@pytest.mark.parametrize("per_channel,axis", [(False, -1), (True, -1), (True, 0)])
def test_percentile_ranges_match_jax(rng, per_channel, axis):
    x = (rng.normal(size=(37, 12)) * 2).astype(np.float32)
    jcfg = jc.EstimatorConfig(jc.RangeMethod.current_minmax, percentile=1.5)
    tcfg = tc.EstimatorConfig(tc.RangeMethod.current_minmax, percentile=1.5)
    jq, tq = jc.QuantizerConfig(), tc.QuantizerConfig()
    js = je.init(jcfg, jq, x.shape, per_channel, axis)
    ts = te.init(tcfg, tq, x.shape[axis] if per_channel else 1)
    _, jr = _j_update(jcfg, jq, js, jnp.asarray(x), per_channel, axis)
    ts, tr = te.update(tcfg, tq, ts, torch.from_numpy(x), per_channel, axis)
    for t, j in zip(tr[:2], jr[:2]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)
    assert float(tr[1].max()) < x.max() and float(tr[0].min()) > x.min()
    assert int(ts["count"]) == 1


@pytest.mark.parametrize("opt", ["grid", "golden_section"])
@pytest.mark.parametrize("one_sided", [False, True], ids=["two_sided", "one_sided"])
def test_line_search_matches_jax(rng, opt, one_sided):
    x = (rng.normal(size=(500,)) * 2).astype(np.float32)
    if one_sided:
        x = np.abs(x)
    jq = jc.QuantizerConfig(fp8=jc.FP8Config(set_maxval=True))
    tq = tc.QuantizerConfig(fp8=tc.FP8Config(set_maxval=True))
    jr = _j_line_search(x, jq, 200, opt_method=opt)
    tr = te.line_search_ranges(torch.from_numpy(x), tq, num_candidates=200, opt_method=opt)
    for t, j in zip(tr, jr):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)
    assert (float(tr[0]) == 0.0) == one_sided
    if opt == "grid":
        # a caller's quantizer, once a candidate, picks the same threshold
        from fp8_quantization_tpu_torch.quant import quantizers as tqz

        def apply_fn(x, lo, hi):
            st = tqz.set_quant_range(tq, tqz.init(tq), lo, hi)
            return tqz.apply(tq, st, x)

        own = te.line_search_ranges(torch.from_numpy(x), tq, num_candidates=200,
                                    apply_fn=apply_fn)
        np.testing.assert_array_equal(own[1].numpy(), tr[1].numpy())


def _site_pair(per_channel, x0):
    """A JAX site initialized on ``x0`` with its MSE state then replaced by a
    fresh one, and the port's site loaded from those variables."""
    jq, tq = _qcfg(jc, per_channel), _qcfg(tc, per_channel)
    jcfg, tcfg = jc.EstimatorConfig(jc.RangeMethod.MSE), tc.EstimatorConfig(tc.RangeMethod.MSE)
    jsite = jsites.QuantSite(jq, jcfg, channel_axis=-1)
    variables = dict(jax.jit(jsite.init, static_argnums=2)(
        jax.random.key(0), jnp.asarray(x0), jsites.ESTIMATE))
    c = x0.shape[-1] if per_channel else 1
    variables["quant_est"] = {"est": je.init(jcfg, jq, x0.shape, per_channel, -1)}
    tsite = tsites.QuantSite(tq, tcfg, channel_axis=-1, num_channels=c)
    tsite.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables)))
    return jsite, variables, tsite


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_quant_site_mse_estimate_then_fixed(rng, per_channel):
    """ESTIMATE on two batches writes the elected width into the site's
    ``mantissa_bits``; FIXED then quantizes at it as the JAX site does, and
    FAST (K1's plain version on the CPU) refreezes its scalars to it."""
    xs = [(rng.normal(size=(6, 8)) * s).astype(np.float32) for s in (1.0, 3.0, 2.0)]
    jsite, variables, tsite = _site_pair(per_channel, xs[0])
    estimate = jax.jit(lambda v, x: jsite.apply(v, x, jsites.ESTIMATE,
                                                 mutable=["quant", "quant_est"])[1])
    for x in xs[:2]:
        variables = {**variables, **estimate(variables, jnp.asarray(x))}
        tsite(torch.from_numpy(x), tsites.ESTIMATE)
    jest = variables["quant_est"]["est"]
    tstate = {k: getattr(tsite, k) for k in tsite.est_keys}
    jq_state = variables["quant"]["q"]
    elected = float(jq_state["mantissa_bits"][0])
    assert float(tsite.mantissa_bits[0]) == elected and elected != 4.0
    hold_election(jest, (None, jq_state["maxval"], jq_state["mantissa_bits"]),
                  tstate, (None, tsite.maxval, tsite.mantissa_bits))
    x = (rng.normal(size=(5, 8)) * 4).astype(np.float32)
    jy = np.asarray(jax.jit(lambda v, x: jsite.apply(v, x, jsites.FIXED))(
        variables, jnp.asarray(x)))
    ty = tsite(torch.from_numpy(x), tsites.FIXED).numpy()
    if np.array_equal(tsite.maxval.numpy(), np.asarray(jq_state["maxval"])):
        np.testing.assert_array_equal(ty, jy)
    if not per_channel:
        before = k1.quantize_block.launches
        fast = tsite(torch.from_numpy(x), tsites.FAST)
        assert k1.quantize_block.launches == before            # CPU: the plain version
        np.testing.assert_array_equal(fast.float().numpy(), ty)


def test_zeros_init_forward_departure(rng):
    """The JAX CLI's zeros init forward gives an MSE input site the grid
    ``linspace(0, 0)``, and its ``maxval`` stays 0 after a real batch. The
    port resets the search after that forward (``reset_search_grids``), so
    its site reads the real batch's grid: the ranges of a fresh state."""
    x = (rng.normal(size=(2, 4, 4, 3)) * 2).astype(np.float32)
    zeros = np.zeros((1, 4, 4, 3), np.float32)
    jq, tq = _qcfg(jc), _qcfg(tc)
    jcfg, tcfg = jc.EstimatorConfig(jc.RangeMethod.MSE), tc.EstimatorConfig(tc.RangeMethod.MSE)
    jsite = jsites.QuantSite(jq, jcfg)
    variables = jax.jit(jsite.init, static_argnums=2)(
        jax.random.key(0), jnp.asarray(zeros), jsites.ESTIMATE)
    _, ups = jax.jit(lambda v, x: jsite.apply(v, x, jsites.ESTIMATE,
                                              mutable=["quant", "quant_est"]))(
        variables, jnp.asarray(x))
    assert float(ups["quant"]["q"]["maxval"][0]) == 0.0

    tsite = tsites.QuantSite(tq, tcfg)
    tsite(torch.from_numpy(zeros), tsites.ESTIMATE)
    tsites.reset_search_grids(tsite)
    assert int(tsite.count) == 0 and float(tsite.search_grid.abs().max()) == 0.0
    tsite(torch.from_numpy(x), tsites.ESTIMATE)
    fresh = je.init(jcfg, jq, x.shape, False)
    fresh, jr = _j_update(jcfg, jq, fresh, jnp.asarray(x), False, 0)
    assert float(tsite.maxval[0]) > 0
    hold_election(fresh, jr, {k: getattr(tsite, k) for k in tsite.est_keys},
                  (None, tsite.maxval, tsite.mantissa_bits))
    # a min/max site keeps its seeding from the init forward
    mm = tsites.QuantSite(tq, tc.EstimatorConfig(tc.RangeMethod.allminmax))
    mm(torch.from_numpy(zeros), tsites.ESTIMATE)
    tsites.reset_search_grids(mm)
    assert int(mm.count) == 1 and float(mm.xmax[0]) == 0.0
