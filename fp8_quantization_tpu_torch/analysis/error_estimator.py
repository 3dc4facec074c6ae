"""Analytic expected quantization error: MSE of rounding and dot products.

A copy of the JAX package's ``analysis/error_estimator.py`` (numpy only; it
computes on the host in both packages). It re-derives the reference's
``utils/grid.py`` and ``quantization/quant_error_estimator.py``: piecewise
integration of pdf-weighted rounding-error functionals over a quantization
grid (each bin split at its midpoint between neighbouring grid points),
boundary point masses for clipped distributions, and the six-term expansion
of the expected dot-product MSE

  E[(xy - q(x)q(y))²] ≈ Rx·My + Ry·Mx + Rx·Ry + 2·Sx·Sy + 2·Rx·Sy + 2·Ry·Sx

with R = E[(q(x)-x)²], M = E[x²], S = E[x(q(x)-x)]
(quant_error_estimator.py:40-64). Empirical Monte-Carlo cross-checks warn
when analytic and sampled estimates diverge >10%
(quant_error_estimator.py:150-159).
"""

from __future__ import annotations

import logging

import numpy as np

from .distributions import ClippedGaussDistr, ClippedStudentTDistr, DistrBase

logger = logging.getLogger(__name__)


def quant_scalar_nearest(x: float, grid: np.ndarray) -> float:
    """Nearest grid value (utils/grid.py:22-26)."""
    return float(grid[np.argmin(np.abs(x - grid))])


def integrate_pdf_grid_func_analyt(distr: DistrBase, grid, func_name: str):
    """Integrate a per-interval functional over all quantization bins
    (utils/grid.py:46-93): each [g_i, g_{i+1}] splits at the midpoint — the
    left half rounds to g_i, the right half to g_{i+1}; out-of-grid tails
    round to the end points; clipped distributions add point masses at the
    range bounds."""
    grid = np.sort(np.asarray(grid, dtype=np.float64))
    fn = getattr(distr, func_name)
    res = 0.0

    if distr.range_min < grid[0]:
        res += fn(distr.range_min, grid[0], grid[0])

    for i in range(len(grid) - 1):
        mid = 0.5 * (grid[i] + grid[i + 1])
        a1, b1 = max(grid[i], distr.range_min), min(mid, distr.range_max)
        a2, b2 = max(mid, distr.range_min), min(grid[i + 1], distr.range_max)
        if a1 < b1:
            res += fn(a1, b1, grid[i])
        if a2 < b2:
            res += fn(a2, b2, grid[i + 1])

    if distr.range_max > grid[-1]:
        res += fn(grid[-1], distr.range_max, grid[-1])

    clipped = isinstance(distr, (ClippedGaussDistr, ClippedStudentTDistr))
    if clipped:
        q_min = quant_scalar_nearest(distr.range_min, grid)
        q_max = quant_scalar_nearest(distr.range_max, grid)
        if func_name == "integr_interv_x_p_signed_r":
            res += (
                distr.range_min * (q_min - distr.range_min) * distr.point_mass_range_min
                + distr.range_max * (q_max - distr.range_max) * distr.point_mass_range_max
            )
        elif func_name == "integr_interv_p_sqr_r":
            res += (
                (q_min - distr.range_min) ** 2 * distr.point_mass_range_min
                + (q_max - distr.range_max) ** 2 * distr.point_mass_range_max
            )
    return res


def expected_rounding_mse(distr: DistrBase, grid) -> float:
    """E[(q(x) - x)²] (quant_error_estimator.py:35-37)."""
    return integrate_pdf_grid_func_analyt(distr, grid, "integr_interv_p_sqr_r")


def expected_dot_prod_mse_analyt(distr_x, grid_x, distr_y, grid_y) -> float:
    """Six-term expansion (quant_error_estimator.py:40-64)."""
    rx = expected_rounding_mse(distr_x, grid_x)
    ry = expected_rounding_mse(distr_y, grid_y)
    mx = distr_x.eval_non_central_second_moment()
    my = distr_y.eval_non_central_second_moment()
    sx = integrate_pdf_grid_func_analyt(distr_x, grid_x, "integr_interv_x_p_signed_r")
    sy = integrate_pdf_grid_func_analyt(distr_y, grid_y, "integr_interv_x_p_signed_r")
    return rx * my + ry * mx + rx * ry + 2.0 * sx * sy + 2.0 * rx * sy + 2.0 * ry * sx


def _quantize_to_grid(x: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Round-to-nearest onto an arbitrary (sorted) grid."""
    grid = np.sort(np.asarray(grid))
    idx = np.searchsorted(grid, x)
    idx = np.clip(idx, 1, len(grid) - 1)
    lo, hi = grid[idx - 1], grid[idx]
    return np.where(np.abs(x - lo) <= np.abs(hi - x), lo, hi)


def empirical_rounding_mse(distr: DistrBase, grid, num_samples: int = 2_000_000,
                           seed: int = 10) -> float:
    rng = np.random.default_rng(seed)
    x = distr.sample((num_samples,), rng)
    return float(np.mean((_quantize_to_grid(x, grid) - x) ** 2))


def compute_expected_quant_mse(distr: DistrBase, grid,
                               num_samples: int = 2_000_000) -> float:
    """Analytic expected MSE with an empirical sanity check
    (quant_error_estimator.py:135-161)."""
    err_analyt = expected_rounding_mse(distr, grid)
    err_emp = empirical_rounding_mse(distr, grid, num_samples)
    rel = abs((err_emp - err_analyt) / err_analyt)
    if rel > 0.1:
        logger.warning(
            "analytic vs empirical quant-MSE relative difference %.3f > 0.1; "
            "consider more samples", rel,
        )
    return err_analyt


def compute_expected_dot_prod_mse(distr_x, grid_x, distr_y, grid_y,
                                  num_samples: int = 2_000_000) -> float:
    """(quant_error_estimator.py:89-132)."""
    err_analyt = expected_dot_prod_mse_analyt(distr_x, grid_x, distr_y, grid_y)
    rng = np.random.default_rng(10)
    x = distr_x.sample((num_samples,), rng)
    y = distr_y.sample((num_samples,), rng)
    qx = _quantize_to_grid(x, grid_x)
    qy = _quantize_to_grid(y, grid_y)
    err_emp = float(np.mean((x * y - qx * qy) ** 2))
    rel = abs((err_emp - err_analyt) / max(abs(err_analyt), 1e-30))
    if rel > 0.1:
        logger.warning(
            "analytic vs empirical dot-prod-MSE relative difference %.3f > 0.1",
            rel,
        )
    return err_analyt
