"""The port's ``analysis`` package, ``analysis/inspect.py`` and the
``compute_quant_error`` / ``fp8_grid_check`` entry points against the JAX
package's and the root scripts, on the CPU.

``analysis/distributions.py`` and ``analysis/error_estimator.py`` are numpy
and scipy in both packages: every quantity is equal bit for bit (the
Monte-Carlo estimates at small sample counts, from the same seeds). The
inspect rows are held to JAX's over carried weights (``models.bridge``), the
names mapped (``/`` to ``.``, the site's ``q`` level dropped): equal. The
quantization-error script's numbers are the analytic MSEs, equal to the root
script's at 20,000 samples.
"""

import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import compute_quant_error as root_cqe
from fp8_quantization_tpu import analysis as janalysis
from fp8_quantization_tpu import config as jc
from fp8_quantization_tpu.analysis import error_estimator as j_est
from fp8_quantization_tpu.analysis import inspect as j_inspect
from fp8_quantization_tpu.numerics import fp8_grid_scaled
from fp8_quantization_tpu.ops import layers as jlayers
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import analysis as tanalysis
from fp8_quantization_tpu_torch import compute_quant_error as t_cqe
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch import fp8_grid_check
from fp8_quantization_tpu_torch.analysis import error_estimator as t_est
from fp8_quantization_tpu_torch.analysis import inspect as t_inspect
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.ops import layers as tlayers

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

DISTRS = {
    "gauss": lambda m: m.ClippedGaussDistr({"mu": 0.5, "sigma": 2.0}, -3.0, 5.0),
    "student_t": lambda m: m.ClippedStudentTDistr({"nu": 8.0}, -6.0, 6.0),
    "uniform": lambda m: m.UniformDistr(None, -2.0, 2.0),
}


def _grids():
    fp = fp8_grid_scaled(8, 4, 8, 4.0)
    return {"fp8": fp, "int8": 4.0 / 127 * np.arange(-128, 128),
            "fp6": fp8_grid_scaled(6, 3, 4, 4.0)}


@pytest.mark.parametrize("name", list(DISTRS))
def test_distributions_match_jax(name):
    """Partial moments, interval integrands, point masses, pdf, cdf and
    samples: equal."""
    jd, td = DISTRS[name](janalysis), DISTRS[name](tanalysis)
    assert (td.point_mass_range_min, td.point_mass_range_max) == (
        jd.point_mass_range_min, jd.point_mass_range_max)
    for a, b, u in ((-1.0, 0.5, 0.25), (0.0, 3.0, 2.0), (-2.5, -2.0, -2.2)):
        for fn in ("i0", "i1", "i2"):
            assert getattr(td, fn)(a, b) == getattr(jd, fn)(a, b), fn
        for fn in ("integr_interv_p_sqr_r", "integr_interv_x_p_signed_r"):
            assert getattr(td, fn)(a, b, u) == getattr(jd, fn)(a, b, u), fn
    assert td.eval_non_central_second_moment() == jd.eval_non_central_second_moment()
    xs = np.linspace(-3.0, 3.0, 13)
    np.testing.assert_array_equal(td.pdf(xs), jd.pdf(xs))
    np.testing.assert_array_equal(td.cdf(xs), jd.cdf(xs))
    np.testing.assert_array_equal(td.sample((50,), np.random.default_rng(3)),
                                  jd.sample((50,), np.random.default_rng(3)))


@pytest.mark.parametrize("name,grid", [("gauss", "fp6"), ("student_t", "int8"),
                                       ("uniform", "fp8"), ("uniform", "int8")])
def test_error_estimator_matches_jax(name, grid):
    """The analytic rounding and dot-product MSEs, the interval integrals,
    and the Monte-Carlo estimates at 2,000 samples: equal (each scipy-bound
    integral takes ~0.3 s over a 256-point grid, so the cases are few and the
    Gaussian's grid is a 6-bit one)."""
    jd, td = DISTRS[name](janalysis), DISTRS[name](tanalysis)
    g = _grids()[grid]
    g = g / np.max(np.abs(g)) * max(abs(td.range_min), abs(td.range_max))
    for fn in ("integr_interv_p_sqr_r", "integr_interv_x_p_signed_r"):
        assert t_est.integrate_pdf_grid_func_analyt(td, g, fn) == \
            j_est.integrate_pdf_grid_func_analyt(jd, g, fn)
    assert (tanalysis.empirical_rounding_mse(td, g, 2_000)
            == janalysis.empirical_rounding_mse(jd, g, 2_000))
    assert (tanalysis.compute_expected_quant_mse(td, g, 2_000)
            == janalysis.compute_expected_quant_mse(jd, g, 2_000))
    assert (tanalysis.compute_expected_dot_prod_mse(td, g, td, g, 2_000)
            == janalysis.compute_expected_dot_prod_mse(jd, g, jd, g, 2_000))
    x = np.random.default_rng(1).normal(size=300)
    np.testing.assert_array_equal(t_est._quantize_to_grid(x, g), j_est._quantize_to_grid(x, g))


class JNet(fnn.Module):
    """A quantized dense layer and LayerNorm of the JAX package."""
    qc: jc.QuantConfig

    @fnn.compact
    def __call__(self, x, qp):
        x = jlayers.QuantDense(qc=self.qc, features=16, name="fc")(x, qp)
        return jlayers.QuantLayerNorm(qc=self.qc, name="ln")(x, qp)


class TNet(torch.nn.Module):
    def __init__(self, qc):
        super().__init__()
        self.fc = tlayers.QuantDense(qc, 8, 16)
        self.ln = tlayers.QuantLayerNorm(qc, 16)

    def forward(self, x, qp):
        return self.ln(self.fc(x, qp), qp)


def _qc(mod, method):
    return mod.QuantConfig(
        method=mod.QMethod(method), per_channel_weights=True, quantize_input=True,
        weight_range=mod.EstimatorConfig(mod.RangeMethod.current_minmax),
        act_range=mod.EstimatorConfig(mod.RangeMethod.allminmax),
        fp8=mod.FP8Config(set_maxval=True, mse_include_mantissa_bits=False),
        run_method=mod.RunMethodConfig(res_quantizer_flag=True))


def _jax_rows(rows):
    """JAX's row names in the port's spelling."""
    return [dict(r, name=r["name"].replace("/q/", "/").replace("/", ".")) for r in rows]


@pytest.mark.parametrize("method", ["fp_quantizer", "symmetric_uniform"])
def test_inspect_rows_match_jax(method, rng, tmp_path):
    """``weight_summaries`` over the carried parameters and
    ``quant_state_summary`` over the calibrated sites (from the module and
    from its ``state_dict``: the quantizer state, no estimator state) equal
    JAX's rows; ``weight_histograms`` writes one PNG a tensor where
    matplotlib is installed, as JAX's does, and returns [] where it is not."""
    x = rng.normal(size=(4, 8)).astype(np.float32)
    jm = JNet(qc=_qc(jc, method))
    params = {"fc": {"kernel": rng.normal(size=(8, 16)).astype(np.float32),
                     "bias": rng.normal(size=(16,)).astype(np.float32)},
              "ln": {"scale": rng.normal(size=(16,)).astype(np.float32),
                     "bias": rng.normal(size=(16,)).astype(np.float32)}}
    # compiled: the min/max site state is exact in any order
    _, ups = jax.jit(lambda v, x: jm.apply(v, x, jsites.ESTIMATE, mutable=[
        "quant", "quant_est"]))({"params": params}, jnp.asarray(x))
    jv = {"params": params, **jax.tree.map(np.asarray, dict(ups))}
    tm = TNet(_qc(tc, method))
    tm.load_state_dict(from_jax_variables(jv), strict=True)

    assert sorted(t_inspect.weight_summaries(tm.named_parameters()), key=str) == \
        sorted(_jax_rows(j_inspect.weight_summaries(jv["params"])), key=str)
    want = _jax_rows(j_inspect.quant_state_summary(jv))
    assert want and sorted(t_inspect.quant_state_summary(tm), key=str) == sorted(want, key=str)
    assert sorted(t_inspect.quant_state_summary(tm.state_dict()), key=str) == sorted(want,
                                                                                     key=str)
    assert not any(("xmin" in r["name"] or "count" in r["name"])
                   for r in t_inspect.quant_state_summary(tm.state_dict()))

    written = t_inspect.weight_histograms(tm.named_parameters(), str(tmp_path / "t"),
                                          select="fc")
    j_written = j_inspect.weight_histograms(jv["params"], str(tmp_path / "j"), select="fc")
    assert sorted(n for n, _ in written) == sorted(n.replace("/", ".") for n, _ in j_written)
    assert len(written) == 2
    assert all(os.path.exists(f) for _, f in written)


def test_weight_histograms_without_matplotlib(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert t_inspect.weight_histograms({"w": torch.ones(4, 4)}, str(tmp_path)) == []


@pytest.mark.parametrize("distr", ["gauss", "student_t", "uniform"])
def test_compute_quant_error_matches_root_script(distr, capsys):
    """The port's module against the root script's function: equal MSEs
    and printout at 20,000 samples."""
    ours = t_cqe.compute_quant_error(distr, 20_000)
    out_ours = capsys.readouterr().out
    theirs = root_cqe.compute_quant_error(distr, 20_000)
    assert ours == theirs and out_ours == capsys.readouterr().out
    if distr == "uniform":
        # the command line (the closed-form uniform integrals are quick)
        assert t_cqe.main(["--distr", distr, "--num-samples", "20000",
                           "--mantissa-bits", "3"]) == root_cqe.compute_quant_error(
                               distr, 20_000, 3)


def test_fp8_grid_check_on_the_cpu(capsys):
    """Every grid is a fixed point of the port's ``quantize_to_fp8_ste``;
    without ``--no-cuda`` the check needs a GPU and raises here."""
    assert fp8_grid_check.main(["--no-cuda"]) == 0
    out = capsys.readouterr().out
    assert out.count("round-trip idempotent on cpu: True") == len(fp8_grid_check.FORMATS)
    assert "all grids verified" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fp8_grid_check.main([])
