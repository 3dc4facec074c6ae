"""K3's significand table: every single product of the approximate-multiplier
GEMM rebuilt from the table the wrapper builds and the exponent sum, as the
CUDA kernel builds it (``ops/cuda/approx_matmul.py::table_products``), equal
bit for bit to the port's plain ``approx_products`` (a zero's sign aside,
which no sum that starts at +0 keeps).

The identity behind the table: codec requantization rounds |v| in v's own
binade and clamps at the binade top, so within the normal binades of the
result grid it commutes with a power of two, and every value a product can
take depends only on the two operands' (subnormal flag, normalized
mantissa), the sign and u = ea + eb + bias_r - 1. The checks run over value
space x value space (K = 1) of E3M4, E4M3 and E2M5 in the eight flag cases
of ``tests/test_approx_pallas.py``, with operand biases and a sweep of
result biases that lands the products in every binade of the result grid:
below half its smallest step, subnormal, normal, its top binade and above
max_norm (golden_clip_of). One E3M4 case is also held to JAX's
``approx_matmul_pallas`` in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.ops.pallas.approx_matmul import approx_matmul_pallas
from fp8_quantization_tpu_torch.numerics.approx_matmul import approx_products
from fp8_quantization_tpu_torch.numerics.codec import value_space
from fp8_quantization_tpu_torch.numerics.luts import get_error_table
from fp8_quantization_tpu_torch.ops.cuda import approx_matmul as k3
from test_torch_cuda import CASES, case_id

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

# operand biases (a, b) and result biases: E3M4's value space at bias 5
# spans binades -8..2, at 3 binades -6..4, so bias_r from -12 to 27 moves
# the products from wholly below the result grid's smallest step to wholly
# above its max_norm
SPACE_BIASES = ((5, 3), (2, 9))
BIAS_R = tuple(range(-12, 30, 3))
FLAG_KEYS = ("with_approx", "with_s2nn2s_opt", "quant_btw_mult_accu", "golden_clip_of")


def _flags(case):
    return {"dnsmp_factor": 3, "with_approx": True, "with_s2nn2s_opt": False,
            "quant_btw_mult_accu": True, "golden_clip_of": False, **case}


def _signed_space(ew, mw, bias):
    vs = value_space(ew, mw, bias)
    return torch.cat([vs, -vs[1:]])


def _bits(x):
    return (x + 0.0).view(torch.int32)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_table_rebuilds_every_single_product(case):
    kw = _flags(case)
    ew, mw = kw["expo_width"], kw["mant_width"]
    lut = get_error_table(ew, mw, kw["with_comp"], 3)
    flags = {key: kw[key] for key in FLAG_KEYS}
    reached = set()
    for ba, bb in SPACE_BIASES:
        a = _signed_space(ew, mw, ba).reshape(-1, 1)
        b = _signed_space(ew, mw, bb).reshape(1, -1)
        for br in BIAS_R:
            plain = approx_products(a, b, ew, mw, ba, bb, br, lut, **flags)
            rebuilt = k3.table_products(a, b, ba, bb, br, **kw)
            bad = _bits(rebuilt) != _bits(plain)
            assert not bad.any(), (ba, bb, br, a.reshape(-1)[bad.nonzero()[0, 0]].item(),
                                   b.reshape(-1)[bad.nonzero()[0, 2]].item())
            # the binades of the result grid the raw products reached
            raw = (a[:, :, None] * b[None]).abs()
            step = 2.0 ** (1 - br - mw)
            min_norm = 2.0 ** (1 - br)
            max_norm = (2.0 - 2.0 ** -mw) * 2.0 ** ((1 << ew) - 1 - br)
            reached |= {name for name, hit in (
                ("below half a step", ((raw > 0) & (raw < step / 2)).any()),
                ("subnormal", ((raw >= step) & (raw < min_norm)).any()),
                ("normal", ((raw >= min_norm) & (raw < max_norm / 2)).any()),
                ("top", ((raw >= max_norm / 2) & (raw <= max_norm)).any()),
                ("above max_norm", (raw > max_norm).any()),
            ) if bool(hit)}
    assert reached == {"below half a step", "subnormal", "normal", "top", "above max_norm"}


def test_table_layout():
    """Slots span the u where outputs change; the zero index reads zero at
    every slot; the device layout pads the slot axis to an odd stride and
    appends the LUT times 2^-M."""
    t = k3.significand_table(3, 4, True, 3, True, False, True)
    assert t.values.shape == (32, 32, t.slots) and t.slots > 1
    z = k3.zero_index(4)
    assert not t.values[z].any() and not t.values[:, z].any()
    flat, slots, u_lo = k3._device_table(3, 4, True, 3, True, False, True,
                                         torch.device("cpu"))
    stride = slots | 1
    assert (slots, u_lo) == (t.slots, t.u_lo)
    assert flat.numel() == 32 * 32 * stride + 16 * 16
    lut = torch.as_tensor(get_error_table(3, 4, True, 3), dtype=torch.float32) / 16
    assert torch.equal(flat[32 * 32 * stride:].reshape(16, 16), lut)
    idx, e = k3.operand_fields(torch.tensor([0.0, -0.0, 1.5, -0.046875]), 5, 4)
    # 0.046875 = 1.5 * 2^-5 is subnormal on ExMy(bias 5) (below 2^-4)
    assert idx.tolist() == [z, z, 8, 16 + 8] and e.tolist() == [0, 0, 0, -5]


@pytest.mark.parametrize("br", [-6, 2, 9])
def test_table_matches_pallas_kernel(br):
    """E3M4 with the D3 table: the rebuilt single products equal JAX's
    Pallas kernel at K = 1 (interpret mode), each output one product."""
    ba, bb = 5, 3
    a = _signed_space(3, 4, ba).reshape(-1, 1)
    b = _signed_space(3, 4, bb).reshape(1, -1)
    rebuilt = k3.table_products(a, b, ba, bb, br, expo_width=3, mant_width=4,
                                with_comp=True)[:, 0, :]
    jax_kernel = np.asarray(approx_matmul_pallas(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), ba, jnp.asarray(np.full(b.shape[1], bb)),
        br, expo_width=3, mant_width=4, with_comp=True))
    np.testing.assert_array_equal(rebuilt.numpy() + 0.0, jax_kernel + 0.0)

