"""Analytic vs empirical expected quantization error for FP8 vs INT8 grids
(port of the root ``compute_quant_error.py``).

    python -m fp8_quantization_tpu_torch.compute_quant_error [--distr gauss|student_t|uniform]
        [--num-samples N] [--mantissa-bits M] [--n-bits B]

~ reference ``compute_quant_error.py:18-70``: for clipped Gaussian /
Student-t / uniform inputs, compare the expected rounding MSE of an FP8
(ExMy) grid against an INT8 grid of the same range. The error model is
numpy and scipy on the host (``analysis``); the samples only check it.
"""

import argparse
import sys

import numpy as np

from .analysis import (ClippedGaussDistr, ClippedStudentTDistr, UniformDistr,
                       compute_expected_quant_mse)
from .numerics import fp8_grid_scaled


def compute_quant_error(distr_name: str, num_samples: int = 1_000_000,
                        mantissa_bits: int = 4, n_bits: int = 8):
    """(FP grid MSE, INT grid MSE) of ``distr_name``'s clipped distribution,
    analytic (the empirical estimate warns where it disagrees by > 10%)."""
    if distr_name == "gauss":
        distr = ClippedGaussDistr({"mu": 0.0, "sigma": 1.0}, -4.0, 4.0)
    elif distr_name == "student_t":
        distr = ClippedStudentTDistr({"nu": 8.0}, -10.0, 10.0)
    elif distr_name == "uniform":
        distr = UniformDistr(None, -1.0, 1.0)
    else:
        raise ValueError(distr_name)

    range_max = max(abs(distr.range_min), abs(distr.range_max))
    ebits = n_bits - 1 - mantissa_bits
    fp_grid = fp8_grid_scaled(n_bits, ebits, 2 ** (ebits - 1), range_max)

    int_max = 2 ** (n_bits - 1) - 1
    delta = range_max / int_max
    int_grid = delta * np.arange(-(int_max + 1), int_max + 1)

    mse_fp = compute_expected_quant_mse(distr, fp_grid, num_samples)
    mse_int = compute_expected_quant_mse(distr, int_grid, num_samples)

    print(f"distr={distr_name} E{ebits}M{mantissa_bits} grid MSE = {mse_fp:.6e}")
    print(f"distr={distr_name} INT{n_bits}       grid MSE = {mse_int:.6e}")
    print(f"FP/INT MSE ratio = {mse_fp / mse_int:.4f}")
    return mse_fp, mse_int


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--distr", default="gauss", choices=["gauss", "student_t", "uniform"])
    p.add_argument("--num-samples", type=int, default=1_000_000)
    p.add_argument("--mantissa-bits", type=int, default=4)
    p.add_argument("--n-bits", type=int, default=8)
    args = p.parse_args(argv)
    return compute_quant_error(args.distr, args.num_samples, args.mantissa_bits, args.n_bits)


if __name__ == "__main__":
    main(sys.argv[1:])
