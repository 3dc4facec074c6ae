"""Offline analytic quantization-error analysis (distributions + grids) and
model inspection (port of ``fp8_quantization_tpu.analysis``: numpy and scipy
on the host, as there)."""

from .distributions import (
    ClippedGaussDistr,
    ClippedStudentTDistr,
    DistrBase,
    UniformDistr,
)
from .error_estimator import (
    compute_expected_dot_prod_mse,
    compute_expected_quant_mse,
    empirical_rounding_mse,
    expected_dot_prod_mse_analyt,
    expected_rounding_mse,
    integrate_pdf_grid_func_analyt,
)

__all__ = [
    "DistrBase",
    "ClippedGaussDistr",
    "ClippedStudentTDistr",
    "UniformDistr",
    "integrate_pdf_grid_func_analyt",
    "expected_rounding_mse",
    "expected_dot_prod_mse_analyt",
    "compute_expected_quant_mse",
    "compute_expected_dot_prod_mse",
    "empirical_rounding_mse",
]
