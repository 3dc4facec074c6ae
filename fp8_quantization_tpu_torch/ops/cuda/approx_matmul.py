"""Approximate-multiplier GEMM: wrapper of the CUDA kernel
``csrc/approx_matmul.cu`` and its plain PyTorch version.

Replaces ``fp8_quantization_tpu/ops/pallas/approx_matmul.py::approx_matmul_pallas``
and takes the same arguments. A tensor on the CPU takes the plain version
(``numerics.approx_matmul.approx_matmul_golden`` with the Pallas kernel's
s2nn2s zero mask, on the requantized golden); a CUDA tensor launches the
kernel or raises. The kernel reads each product's output from a table of
significands built here from the plain version's own products
(:func:`significand_table`) and scales it by the exponent sum; see the
source for why that is exact.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...numerics.approx_matmul import approx_matmul_golden
from ...numerics.luts import get_error_table
from ...numerics.rounding import pow2, to_int32
from . import build

# rows of A per call of the plain version, which materializes (rows, K, N)
PLAIN_ROWS = 64
# output rows per CTA of the kernel (csrc/approx_matmul.cu BM)
KERNEL_ROWS = 32


def _flags(with_approx, with_s2nn2s_opt, quant_btw_mult_accu, golden_clip_of):
    return dict(with_approx=with_approx, with_s2nn2s_opt=with_s2nn2s_opt,
                quant_btw_mult_accu=quant_btw_mult_accu,
                golden_clip_of=golden_clip_of)


def approx_matmul_plain(a, b, bias_a, bias_b, bias_r, *, expo_width: int,
                        mant_width: int, with_comp: bool = False,
                        dnsmp_factor: int = 3, with_approx: bool = True,
                        with_s2nn2s_opt: bool = False,
                        quant_btw_mult_accu: bool = True,
                        golden_clip_of: bool = False):
    """The plain version on any device, in row blocks of ``PLAIN_ROWS``
    (each output row depends only on its own row of ``a``)."""
    table = get_error_table(expo_width, mant_width, with_comp, dnsmp_factor)
    flags = _flags(with_approx, with_s2nn2s_opt, quant_btw_mult_accu, golden_clip_of)
    a = torch.as_tensor(a).to(torch.float32)
    if a.shape[0] == 0:
        return a.new_zeros((0, b.shape[1]))
    return torch.cat([
        approx_matmul_golden(a[r:r + PLAIN_ROWS], b, expo_width, mant_width,
                             bias_a, bias_b, bias_r, table, **flags)
        for r in range(0, a.shape[0], PLAIN_ROWS)
    ])


# The kernel's significand table. A nonzero operand x on its ExMy(bias) grid
# is a sign, its binade e (|x| in [2^e, 2^(e+1))) and an index, 2^M times
# its subnormal flag (|x| < 2^(1 - bias)) plus its normalized mantissa (the
# top M bits of the f32 mantissa; a subnormal has at most M - 1 of them, so
# its mantissa is even). A zero takes the subnormal index of mantissa 1,
# which no value has. A product's output depends only on the two indices,
# the signs and u = ea + eb + bias_r - 1 (its exponent sum against the
# result grid's smallest normal): codec requantization rounds in a value's
# own binade, so it commutes with a power of two within the normal binades,
# and below them each u is a slot of its own. So output = sign *
# table[ia, ib, slot(u)] * 2^(ea + eb), slot(u) = clamp(u - u_lo, 0, slots
# - 1): slot 0 holds every u <= u_lo (rounds to zero, or the unrounded
# golden without quant_btw_mult_accu), the last every u >= u_lo + slots - 1.
# golden_clip_of clamps that at +-max_norm of the result grid instead of
# taking a table of its own.
SCAN_U = range(-40, 24)


class SignificandTable(NamedTuple):
    values: torch.Tensor   # (2^(M+1), 2^(M+1), slots) float32, on the CPU
    u_lo: int
    slots: int


def zero_index(mant_width: int) -> int:
    return (1 << mant_width) + 1


def operand_fields(x, bias, mant_width: int):
    """(index, binade) int32 of :data:`SignificandTable` for f32 ``x`` on its
    ExMy(``bias``) grid (``bias`` broadcasts), as the kernel stages them; a
    zero has index :func:`zero_index` and binade 0."""
    bits = torch.as_tensor(x).to(torch.float32).contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    e = (mag >> 23) - 127
    sub = e < 1 - to_int32(bias, bits.device)
    mant = (mag >> (23 - mant_width)) & ((1 << mant_width) - 1)
    index = torch.where(sub, 1 << mant_width, 0) + mant
    zero = mag == 0
    return (torch.where(zero, zero_index(mant_width), index).to(torch.int32),
            torch.where(zero, 0, e).to(torch.int32))


@functools.lru_cache(maxsize=None)
def significand_table(expo_width: int, mant_width: int, with_comp: bool,
                      dnsmp_factor: int, with_approx: bool, with_s2nn2s_opt: bool,
                      quant_btw_mult_accu: bool) -> SignificandTable:
    """The table of one format, LUT and flag set, built from the plain
    version's own products (``approx_products`` at K = 1): every operand
    index against every other, at each u of :data:`SCAN_U`, divided by
    2^(ea + eb); the slots keep the u where the outputs still change."""
    from ...numerics.approx_matmul import approx_products

    nm = 1 << mant_width
    lut = get_error_table(expo_width, mant_width, with_comp, dnsmp_factor)
    flags = dict(with_approx=with_approx, with_s2nn2s_opt=with_s2nn2s_opt,
                 quant_btw_mult_accu=quant_btw_mult_accu, golden_clip_of=False)
    # operands on the grid of bias b0, where 2^0 is a normal binade: the
    # normal ones in binade 0, the subnormal ones in the top subnormal
    # binade -b0 (even mantissas only; the odd ones stand for zero)
    b0 = 1 << (expo_width - 1)
    sig = 1.0 + torch.arange(nm, dtype=torch.float32) / nm
    odd = torch.arange(nm) % 2 == 1
    sides = ((sig, 0), (torch.where(odd, 0.0, sig * 2.0 ** -b0), -b0))
    scan = torch.tensor(SCAN_U, dtype=torch.int32)
    rel = torch.zeros((len(SCAN_U), 2 * nm, 2 * nm), dtype=torch.float32)
    for fa, (va, ea) in enumerate(sides):
        for fb, (vb, eb) in enumerate(sides):
            # every u at once: b repeated once per u, with a per-column bias_r
            out = approx_products(va.reshape(-1, 1), vb.repeat(len(SCAN_U)).reshape(1, -1),
                                  expo_width, mant_width, b0, b0,
                                  (scan + 1 - ea - eb).repeat_interleave(nm), lut, **flags)
            rel[:, fa * nm:(fa + 1) * nm, fb * nm:(fb + 1) * nm] = (
                out[:, 0, :].reshape(2 ** mant_width, len(SCAN_U), nm).transpose(0, 1)
                * 2.0 ** -(ea + eb))
    z = zero_index(mant_width)
    rel[:, z, :] = 0.0
    rel[:, :, z] = 0.0
    rel = rel + 0.0          # one zero: the sign comes from the operands
    same = [torch.equal(rel[i], rel[i + 1]) for i in range(len(SCAN_U) - 1)]
    lo = next((i for i, s in enumerate(same) if not s), None)
    if lo is None:           # no u dependence at all
        return SignificandTable(rel[0][..., None].contiguous(), SCAN_U[0], 1)
    hi = len(same) - next(i for i, s in enumerate(reversed(same)) if not s)
    if lo == 0 or hi == len(SCAN_U) - 1:
        raise AssertionError(f"E{expo_width}M{mant_width}: the outputs still change at the "
                             f"end of the u scan {SCAN_U}")
    return SignificandTable(rel[lo:hi + 1].permute(1, 2, 0).contiguous(), SCAN_U[lo],
                            hi - lo + 1)


def table_products(a, b, bias_a, bias_b, bias_r, *, expo_width: int, mant_width: int,
                   with_comp: bool = False, dnsmp_factor: int = 3,
                   with_approx: bool = True, with_s2nn2s_opt: bool = False,
                   quant_btw_mult_accu: bool = True, golden_clip_of: bool = False):
    """The (M, K, N) single products as the kernel's table path builds them
    from :func:`significand_table`: one table read at (ia, ib, slot(u)),
    times the power of two 2^(ea + eb) with the product's sign, clamped at
    +-max_norm of the result grid under ``golden_clip_of``. Holds for
    operands on their grids with binades and biases inside the kernel's
    bounds (``EXP_LIMIT``, ``BIAS_LIMIT`` in ``csrc/approx_matmul.cu``,
    which keep 2^(ea + eb) a normal f32); ``bias_r`` is a scalar."""
    t = significand_table(expo_width, mant_width, with_comp, dnsmp_factor, with_approx,
                          with_s2nn2s_opt, quant_btw_mult_accu)
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b, device=a.device).to(torch.float32)
    ia, ea = operand_fields(a, bias_a, mant_width)
    ib, eb = operand_fields(b, to_int32(bias_b, a.device).reshape(1, -1), mant_width)
    br = int(to_int32(bias_r).reshape(()))
    u = ea[:, :, None] + eb[None, :, :] + (br - 1)
    slot = (u - t.u_lo).clamp(0, t.slots - 1)
    values = t.values.to(a.device)
    out = values[ia[:, :, None].long(), ib[None, :, :].long(), slot.long()]
    neg = (a < 0)[:, :, None] ^ (b < 0)[None, :, :]
    out = torch.where(neg, -out, out) * pow2(ea[:, :, None] + eb[None, :, :])
    if golden_clip_of and quant_btw_mult_accu:
        max_norm = (2.0 - 2.0 ** -mant_width) * 2.0 ** ((1 << expo_width) - 1 - br)
        out = out.clamp(-max_norm, max_norm)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("approx_matmul")
    fn = lib.fp8q_approx_matmul
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _device_table(expo_width, mant_width, with_comp, dnsmp_factor, with_approx,
                  with_s2nn2s_opt, quant_btw_mult_accu, device):
    """The kernel's table on ``device``: the significand table with its slot
    axis padded to an odd stride (so a warp's reads of one slot spread over
    the banks), then the LUT times 2^-M (the per-product path's). Returns
    (tensor, slots, u_lo); the kernel derives the stride, ``slots | 1``."""
    t = significand_table(expo_width, mant_width, with_comp, dnsmp_factor, with_approx,
                          with_s2nn2s_opt, quant_btw_mult_accu)
    stride = t.slots | 1
    values = torch.nn.functional.pad(t.values, (0, stride - t.slots))
    lut = torch.as_tensor(get_error_table(expo_width, mant_width, with_comp, dnsmp_factor),
                          dtype=torch.float32) * 2.0 ** -mant_width
    flat = torch.cat([values.reshape(-1), lut.reshape(-1)])
    return flat.to(device).contiguous(), t.slots, t.u_lo


def _scalar_i32(v, device):
    return to_int32(v, device).reshape(1).contiguous()


def approx_matmul(a, b, bias_a, bias_b, bias_r, *, expo_width: int,
                  mant_width: int, with_comp: bool = False, dnsmp_factor: int = 3,
                  with_approx: bool = True, with_s2nn2s_opt: bool = False,
                  quant_btw_mult_accu: bool = True, golden_clip_of: bool = False):
    """Approx matmul ``a @ b`` with v9 float-domain simulation semantics.

    a: (M, K) float32 on the ExMy(bias_a) grid; b: (K, N) float32 on the
    ExMy(bias_b[n]) grids; bias_a / bias_r: scalar ints (or one-element
    tensors); bias_b: scalar or (N,) per-output-channel. Returns (M, N)
    float32. ``approx_matmul.launches`` counts kernel launches.
    """
    kwargs = dict(expo_width=expo_width, mant_width=mant_width,
                  with_comp=with_comp, dnsmp_factor=dnsmp_factor,
                  **_flags(with_approx, with_s2nn2s_opt, quant_btw_mult_accu,
                           golden_clip_of))
    if a.device.type == "cpu":
        return approx_matmul_plain(a, b, bias_a, bias_b, bias_r, **kwargs)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"approx_matmul takes CPU or CUDA tensors on one device, "
                         f"got {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"approx_matmul takes float32, got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (1 <= mant_width <= 5):
        raise ValueError(f"mant_width={mant_width}: the LUT kernel takes 1..5")
    m, k = a.shape
    n = b.shape[1]
    if m > KERNEL_ROWS * 65535:
        raise ValueError(f"M={m} exceeds the kernel's grid")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    a = a.contiguous()
    b = b.contiguous()
    dev = a.device
    bias_b = to_int32(bias_b, dev).reshape(-1)
    if bias_b.numel() not in (1, n):
        raise ValueError(f"bias_b has {bias_b.numel()} entries for {n} columns")
    bias_b = bias_b.expand(n).contiguous()
    bias_a_t = _scalar_i32(bias_a, dev)
    bias_r_t = _scalar_i32(bias_r, dev)
    table, slots, u_lo = _device_table(expo_width, mant_width, with_comp, dnsmp_factor,
                                          with_approx, with_s2nn2s_opt, quant_btw_mult_accu,
                                          dev)
    launch = _lib()
    with torch.cuda.device(dev):
        err = launch(
            a.data_ptr(), b.data_ptr(), bias_a_t.data_ptr(), bias_b.data_ptr(),
            bias_r_t.data_ptr(), table.data_ptr(), out.data_ptr(),
            m, n, k, expo_width, mant_width, slots, u_lo, int(with_approx),
            int(quant_btw_mult_accu), int(golden_clip_of), int(with_s2nn2s_opt),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"approx_matmul kernel launch failed: CUDA error {err}")
    approx_matmul.launches += 1
    return out


approx_matmul.launches = 0
