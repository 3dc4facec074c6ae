"""FP8 grid sanity check (port of the root ``fp8_grid_check.py``; ~
reference root-level ``test.py:1-71``).

    python -m fp8_quantization_tpu_torch.fp8_grid_check [--no-cuda]

Prints the E4M3 / E3M4 / E5M2 value spaces and checks that each grid is a
fixed point of ``quantize_to_fp8_ste``: quantizing every grid value returns
it bit for bit. It runs on the GPU unless ``--no-cuda`` is given (and
raises where there is none), so it catches a device whose transcendentals
round otherwise than the bit-exact ``ldexp``/``frexp`` arithmetic the
quantizer needs. Exits non-zero if a grid is not a fixed point.
"""

import argparse
import sys

import numpy as np
import torch

from .cli import select_device
from .numerics import fp8_grid, fp8_max_value, quantize_to_fp8_ste, value_space

# (exponent bits, mantissa bits, bias) of the formats checked
FORMATS = ((4, 3, 8), (3, 4, 4), (5, 2, 16))


def check_grids(device) -> bool:
    """Print each format's value space and whether its grid is a fixed
    point of ``quantize_to_fp8_ste`` on ``device``; True if all are."""
    all_ok = True
    for ebits, mant, bias in FORMATS:
        grid = fp8_grid(8, ebits, bias)
        print(f"\nE{ebits}M{mant} (bias {bias}): {len(grid)} values, "
              f"max {fp8_max_value(ebits, bias)}")
        print("  positive value space:", np.array2string(grid[grid >= 0][:16], precision=6),
              "...")
        g = torch.from_numpy(grid.astype(np.float32)).to(device)
        maxval = torch.tensor([float(np.max(np.abs(grid)))], device=device)
        q, derived_bias = quantize_to_fp8_ste(g, 8, maxval, float(mant), 1)
        ok = bool(torch.equal(q, g))
        all_ok &= ok
        print(f"  round-trip idempotent on {device.type}: {ok}; derived bias "
              f"{float(derived_bias.reshape(-1)[0]):.0f}")
        vs = value_space(ebits, mant, bias)
        print(f"  codec value space head: {np.array2string(vs[:8].numpy(), precision=6)}")
    return all_ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cuda", action=argparse.BooleanOptionalAction, default=True,
                   help="run on the GPU (raises if there is none)")
    args = p.parse_args(argv)
    ok = check_grids(select_device(args.cuda))
    print("\nall grids verified" if ok else "\na grid is not a fixed point of the quantizer")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
