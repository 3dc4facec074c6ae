"""The route choice of the GEMM kernels K2 and K4 and route B's numerics
contract, on the CPU.

K2 (``fused_quant_matmul``) and K4 (``dequant_matmul``) launch one kernel a
call, whose route depends on M alone: bit-exact streaming for M <= 16
(route A, equal to the plain versions bit for bit) and tensor-core tiles
above (route B). Route B sums in the tensor cores' order, so it is held to
``fused_matmul.within_requant_step``: within ``K * 2^-24 * sum_k |x_k w_k|``
of the plain sum before any requant, and after the requant epilogue equal to
the plain output or exactly one step of the result grid away where the plain
sum lies within that tolerance of a rounding midpoint, with at least 99%
equal (the JAX package's contract, ``tests/test_fused_matmul.py:88-93``).
The cases here are constructed on the E?M4 result grid of bias 8, whose
step is 1/16 on [1, 2): 1.0 and 1.0625 are neighbours and 1.03125 is the
midpoint between them (rounding half to even gives 1.0).
"""

import pytest
import torch

from fp8_quantization_tpu_torch.ops.cuda import dequant_matmul as k4
from fp8_quantization_tpu_torch.ops.cuda import fused_matmul as k2

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

RES = (8.0, 8, 4, 1)
TINY = torch.tensor(1e-6, dtype=torch.float64)


@pytest.mark.parametrize("m,route", [(0, "A"), (1, "A"), (2, "A"), (4, "A"), (16, "A"),
                                     (17, "B"), (197, "B"), (512, "B"), (1576, "B")])
def test_route_is_a_function_of_m(m, route):
    """K2 and K4 both pass ``ROUTE_A_MAX_M`` to their C entry, which routes
    by it: one route choice for both kernels."""
    assert k2.gemm_route(m) == route
    assert k4.ROUTE_A_MAX_M == k2.ROUTE_A_MAX_M


def test_route_threshold_and_bad_m():
    assert k2.ROUTE_A_MAX_M == 16
    with pytest.raises(ValueError):
        k2.gemm_route(-1)


def _step(ours, plain, tol=TINY, res=RES, **kw):
    return k2.within_requant_step(torch.tensor(ours, dtype=torch.float32),
                                  torch.tensor(plain, dtype=torch.float32), tol, res, **kw)


def test_equal_outputs_pass():
    ok, info = _step([1.0, 1.0625, 0.0], [1.01, 1.06, 0.0])
    assert ok and info["equal_fraction"] == 1.0 and info["steps"] == 0


def test_one_step_at_a_rounding_midpoint_passes():
    """The plain sum sits on the midpoint 1.03125 (it rounds to 1.0); a sum
    within the tolerance above it rounds to 1.0625, one step up."""
    ok, info = _step([1.0625] + [1.0] * 199, [1.03125] * 200)
    assert ok and info["steps"] == 1 and info["equal_fraction"] == pytest.approx(0.995)


def test_one_step_away_from_a_midpoint_fails():
    """1.01 lies 0.02 from the midpoint, far beyond the tolerance."""
    ok, _ = _step([1.0625] + [1.0] * 199, [1.01] * 200)
    assert not ok


def test_two_steps_away_fails_even_inside_a_wide_tolerance():
    """A tolerance wide enough to reach 1.125 from the midpoint still allows
    only the neighbour of the plain output."""
    wide = torch.tensor(0.07, dtype=torch.float64)
    ok, _ = _step([1.125] + [1.0] * 199, [1.03125] * 200, tol=wide)
    assert not ok
    ok, _ = _step([1.0625] + [1.0] * 199, [1.03125] * 200, tol=wide)
    assert ok


def test_fewer_than_99_percent_equal_fails():
    plain = [1.03125] * 100
    ok, info = _step([1.0625] * 2 + [1.0] * 98, plain)
    assert not ok and info["equal_fraction"] == pytest.approx(0.98)
    ok, info = _step([1.0625] + [1.0] * 99, plain)
    assert ok and info["equal_fraction"] == pytest.approx(0.99)


def test_per_element_tolerance_decides_each_step():
    """Two outputs one step up: the first sum is on the midpoint, the second
    0.01 below it, and only the second has a tolerance that reaches it."""
    tol = torch.tensor([1e-6, 0.02] + [1e-6] * 198, dtype=torch.float64)
    ok, _ = _step([1.0625, 1.0625] + [1.0] * 198, [1.03125, 1.02125] + [1.0] * 198, tol=tol)
    assert ok
    tol[1] = 1e-3
    ok, _ = _step([1.0625, 1.0625] + [1.0] * 198, [1.03125, 1.02125] + [1.0] * 198, tol=tol)
    assert not ok


def test_without_requant_the_sum_tolerance_holds():
    plain = torch.tensor([1.0, -2.0, 0.5])
    tol = torch.tensor([1e-3, 1e-3, 0.0], dtype=torch.float64)
    ok, _ = k2.within_requant_step(plain + torch.tensor([9e-4, -9e-4, 0.0]), plain, tol)
    assert ok
    ok, _ = k2.within_requant_step(plain + torch.tensor([2e-3, 0.0, 0.0]), plain, tol)
    assert not ok
    ok, _ = k2.within_requant_step(plain + torch.tensor([0.0, 0.0, 1e-7]), plain, tol)
    assert not ok


def test_bf16_out_without_requant_takes_the_cast_of_the_interval():
    """A bf16 output must be the cast of some sum within the tolerance."""
    plain = torch.tensor([1.0 + 2.0 ** -8])          # the midpoint of 1 and 1 + 2^-7
    near = torch.tensor(1e-6, dtype=torch.float64)
    up = (torch.tensor([1.0 + 2.0 ** -7])).to(torch.bfloat16)
    assert k2.within_requant_step(up, plain, near)[0]
    assert k2.within_requant_step(plain.to(torch.bfloat16), plain, near)[0]
    off = torch.tensor([1.0 + 2.0 ** -6]).to(torch.bfloat16)
    assert not k2.within_requant_step(off, plain, near)[0]


def test_nan_outputs_match_only_nan():
    plain = torch.tensor([float("nan"), 1.0] + [1.0] * 98)
    ok, _ = _step([float("nan"), 1.0] + [1.0] * 98, plain.tolist())
    assert ok
    ok, _ = _step([1.0, 1.0] + [1.0] * 98, plain.tolist())
    assert not ok


def test_sum_tolerance_matches_its_formula():
    x = torch.tensor([[1.0, -2.0, 0.5]])
    w = torch.tensor([[1.0], [0.25], [-4.0]])
    tol = k2.sum_tolerance(x, w)
    assert tol.dtype == torch.float64
    assert float(tol) == pytest.approx(3 * 2.0 ** -24 * (1.0 + 0.5 + 2.0))
