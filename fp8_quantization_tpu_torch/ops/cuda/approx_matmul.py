"""Approximate-multiplier GEMM: wrapper of the CUDA kernel
``csrc/approx_matmul.cu`` and its plain PyTorch version.

Replaces ``fp8_quantization_tpu/ops/pallas/approx_matmul.py::approx_matmul_pallas``
and takes the same arguments. A tensor on the CPU takes the plain version
(``numerics.approx_matmul.approx_matmul_golden`` with the Pallas kernel's
s2nn2s zero mask, on the requantized golden); a CUDA tensor launches the
kernel or raises. The kernel is bound by CUDA-core instruction issue (no
tensor core can do the per-product codec work); see the source for what the
design does about that.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...numerics.approx_matmul import approx_matmul_golden
from ...numerics.luts import get_error_table
from ...numerics.rounding import to_int32
from . import build

# rows of A per call of the plain version, which materializes (rows, K, N)
PLAIN_ROWS = 64


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


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("approx_matmul")
    fn = lib.fp8q_approx_matmul
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _device_lut(expo_width, mant_width, with_comp, dnsmp_factor, device):
    table = get_error_table(expo_width, mant_width, with_comp, dnsmp_factor)
    return torch.as_tensor(table, dtype=torch.int32).to(device).contiguous()


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
    if m > 64 * 65535:
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
    lut = _device_lut(expo_width, mant_width, with_comp, dnsmp_factor, dev)
    launch = _lib()
    with torch.cuda.device(dev):
        err = launch(
            a.data_ptr(), b.data_ptr(), bias_a_t.data_ptr(), bias_b.data_ptr(),
            bias_r_t.data_ptr(), lut.data_ptr(), out.data_ptr(),
            m, n, k, expo_width, mant_width, int(with_approx),
            int(quant_btw_mult_accu), int(golden_clip_of), int(with_s2nn2s_opt),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"approx_matmul kernel launch failed: CUDA error {err}")
    approx_matmul.launches += 1
    return out


approx_matmul.launches = 0
