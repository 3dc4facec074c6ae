"""K3 on the card: the CUDA kernel against its plain PyTorch version.

Every test here needs a GPU (marker ``cuda``) and skips without one: the
kernel has no CPU mode. The file imports neither JAX nor the JAX package, so
it also runs on a GPU machine that has no JAX, without ``tests/conftest.py``
(which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The flag cases are the eight of ``tests/test_approx_pallas.py``;
``tests/test_torch_approx_matmul.py`` holds the plain version against JAX on
the same cases. Tolerance ``rtol=atol=1e-6``, the Pallas tests' own, for
K <= 64: only the summation order over K separates the two.
"""

import numpy as np
import pytest
import torch

from fp8_quantization_tpu_torch.numerics.codec import quantize_exmy
from fp8_quantization_tpu_torch.ops.cuda import approx_matmul as k3

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
