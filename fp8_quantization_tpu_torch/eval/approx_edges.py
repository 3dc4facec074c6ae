"""Where the approximate products of one ``validate-quantized`` run land on
their result grid, counted from the exponent sums of the plain arithmetic.

    python -m fp8_quantization_tpu_torch.eval.approx_edges \\
        validate-quantized --architecture vit_quantized_approx --synthetic-data ...

Runs the CLI's ``validate-quantized`` with the given arguments and, at every
call of the approximate-multiplier GEMM (K3), counts its M K N products by
the exponent sum E = Ea + Eb of their operands (each operand's own binade,
``|a| in [2^Ea, 2^(Ea+1))``) against the result grid's smallest normal
``2^(1 - bias_r)``. With u = E + bias_r - 1 a product ``|a b| in [2^E,
2^(E+2))`` is:

* ``normal``: u >= 0, at or above the smallest normal of the result grid;
* ``boundary``: u = -1, either side of it;
* ``subnormal``: -(M + 2) <= u <= -2, below it, in the subnormal binades;
* ``rounds_to_zero``: u <= -(M + 3), below half the grid's smallest step;
* ``zero_operand``: a or b is zero.

It also counts the operands that are not on their own grid (a value that
``quantize_exmy`` onto ExMy(bias) moves): the kernel sums such an
operand's K-slice by the codec arithmetic instead of its table.

The counts come from per-k histograms of the operands' exponents (their
convolution over k), not from the (M, K, N) products themselves. Prints one
JSON object with the counts and shares over the run's calls.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import cli
from ..numerics.codec import quantize_exmy
from ..numerics.rounding import to_int32
from ..ops.cuda import approx_matmul as k3

BINS = 256          # f32 exponents -128 .. 127
CATEGORIES = ("normal", "boundary", "subnormal", "rounds_to_zero", "zero_operand")


def _exponent_hist(x, dim):
    """Per-k counts of the nonzero entries' binades and of the zero entries:
    ((K, BINS) float64, (K,) float64); ``dim`` is the axis that is counted."""
    bits = x.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF).long()          # biased: binade e - 127, bin e
    zero = (bits & 0x7FFFFFFF) == 0
    if dim == 0:                               # (M, K): count over rows
        e, zero = e.T, zero.T
    k = e.shape[0]
    hist = torch.zeros((k, BINS), dtype=torch.float64, device=x.device)
    hist.scatter_add_(1, e, (~zero).to(torch.float64))
    return hist, zero.to(torch.float64).sum(dim=1)


def product_categories(a, b, bias_r, mant_width: int) -> dict:
    """The counts of :data:`CATEGORIES` over the products of ``a @ b``."""
    ha, za = _exponent_hist(a.to(torch.float32), 0)   # (K, BINS), (K,)
    hb, zb = _exponent_hist(b.to(torch.float32), 1)
    m, n = a.shape[0], b.shape[1]
    size = 2 * BINS
    spec = (torch.fft.rfft(ha, n=size) * torch.fft.rfft(hb, n=size)).sum(dim=0)
    counts = torch.fft.irfft(spec, n=size).round().clamp(min=0)   # bin s: E = s - 254
    e_sum = torch.arange(size, device=a.device) - 254
    u = e_sum + int(to_int32(bias_r).reshape(())) - 1
    out = {
        "normal": counts[u >= 0].sum(),
        "boundary": counts[u == -1].sum(),
        "subnormal": counts[(u <= -2) & (u >= -(mant_width + 2))].sum(),
        "rounds_to_zero": counts[u <= -(mant_width + 3)].sum(),
        "zero_operand": (za * n + zb * m - za * zb).sum(),
    }
    return {key: float(v) for key, v in out.items()}


@torch.no_grad()
def main(argv=None):
    p = argparse.ArgumentParser(prog="fp8_quantization_tpu_torch.eval.approx_edges")
    p.add_argument("cli_args", nargs=argparse.REMAINDER,
                   help="the validate-quantized command line")
    ns = p.parse_args(argv)
    args = cli.build_parser().parse_args(ns.cli_args)
    totals = dict.fromkeys(CATEGORIES, 0.0)
    calls = 0
    kernel = k3.approx_matmul

    off_grid = {"a": 0, "b": 0, "a_values": 0, "b_values": 0}

    def counting(a, b, bias_a, bias_b, bias_r, **kw):
        nonlocal calls
        calls += 1
        for key, v in product_categories(a, b, bias_r, kw["mant_width"]).items():
            totals[key] += v
        ew, mw = kw["expo_width"], kw["mant_width"]
        bb = to_int32(bias_b, b.device).reshape(1, -1)
        off_grid["a"] += int((quantize_exmy(a, ew, mw, to_int32(bias_a, a.device),
                                            clip_of=False) != a).sum())
        off_grid["b"] += int((quantize_exmy(b, ew, mw, bb, clip_of=False) != b).sum())
        off_grid["a_values"] += a.numel()
        off_grid["b_values"] += b.numel()
        return kernel(a, b, bias_a, bias_b, bias_r, **kw)

    counting.launches = 0
    k3.approx_matmul = counting
    try:
        out = cli.run_validate(args)
    finally:
        k3.approx_matmul = kernel
    products = sum(totals.values())
    nonzero = products - totals["zero_operand"]
    print(json.dumps({
        "device": out["device"], "calls": calls, "products": products,
        "counts": totals,
        "share": {key: v / products for key, v in totals.items()},
        "share_of_nonzero": {key: totals[key] / nonzero for key in CATEGORIES[:-1]},
        "operands_off_grid": off_grid,
    }), flush=True)


if __name__ == "__main__":
    main()
