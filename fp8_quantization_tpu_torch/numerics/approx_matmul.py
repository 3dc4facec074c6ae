"""Plain PyTorch approximate FP matmul: the v9 float-domain pipeline (port of
``numerics/approx_matmul.py::approx_matmul_golden``).

The simulated hardware approximates an FP multiply by an integer add of the
operands' bit patterns and corrects the mantissa product with a small LUT:

  approx = 2^(ea+eb-(ba+bb-br) - br) * [(1+ma·2^-M)(1+mb·2^-M) - 2^-M·LUT[ma,mb]]

``bias_b`` / ``bias_r`` may be per-output-channel (N,) vectors. This
formulation materializes the (M, K, N) product tensor. It is the plain
version of the CUDA kernel in ``ops/cuda/approx_matmul.py`` and the oracle
the kernel is held against; do not use it on the hot path.
"""

from __future__ import annotations

import torch

from .. import LATER as _LATER
from .codec import decompose, quantize_exmy
from .rounding import ldexp, to_int32


def _bcast_cols(bias, n_cols, device):
    """A scalar stays (); an (N,) or (1,) bias becomes (1, N|1) for broadcast
    over the columns of a (K, N) operand."""
    bias = to_int32(bias, device)
    if bias.ndim == 0:
        return bias
    if bias.shape[-1] not in (1, n_cols):
        raise ValueError(f"bias shape {tuple(bias.shape)} does not fit {n_cols} columns")
    return bias.reshape(1, -1)


def _mant_product(mant_width, x_mant, y_mant, error_table, with_approx):
    """LUT-compensated mantissa product, normals only."""
    step = 2.0 ** -mant_width
    exact = (1 + x_mant * step) * (1 + y_mant * step)
    if not with_approx:
        return exact
    nm = 1 << mant_width
    comp = error_table.reshape(-1)[(x_mant * nm + y_mant).long()].to(torch.float32)
    return exact - step * comp


def approx_products(A, B, expo_width: int, mant_width: int, bias_a, bias_b,
                    bias_r, error_table, *, with_approx: bool = True,
                    with_s2nn2s_opt: bool = False, golden_clip_of: bool = False,
                    quant_btw_mult_accu: bool = True):
    """The (M, K, N) tensor of approximate partial products whose sum over K
    is :func:`approx_matmul_golden`."""
    A = torch.as_tensor(A).to(torch.float32)
    B = torch.as_tensor(B, device=A.device).to(torch.float32)
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"inner dims differ: {tuple(A.shape)} @ {tuple(B.shape)}")
    dev = A.device
    n = B.shape[1]

    bias_a = to_int32(bias_a, dev).reshape(())
    bias_b2 = _bcast_cols(bias_b, n, dev)
    bias_r2 = _bcast_cols(bias_r, n, dev)
    error_table = torch.as_tensor(error_table, device=dev).to(torch.int32)

    golden_3d = A[:, :, None] * B[None, :, :]
    zero_mask_3d = golden_3d == 0

    if quant_btw_mult_accu:
        golden_3d = quantize_exmy(golden_3d, expo_width, mant_width, bias_r2,
                                  clip_of=golden_clip_of)

    one = torch.ones((), device=dev)
    mant_scale = float(1 << mant_width)
    a_subnorm = torch.abs(A) < ldexp(one, 1 - bias_a)
    b_subnorm = torch.abs(B) < ldexp(one, 1 - bias_b2)

    if with_s2nn2s_opt:
        A = torch.where(a_subnorm, A * mant_scale, A)
        B = torch.where(b_subnorm, B * mant_scale, B)

    a_expo, a_mant = decompose(A, mant_width, bias_a)
    b_expo, b_mant = decompose(B, mant_width, bias_b2)

    b_combine_neg = -(bias_a + bias_b2 - bias_r2)          # () or (1, N)
    approx_expo = a_expo[:, :, None] + b_expo[None, :, :] + b_combine_neg
    sign_3d = torch.where(golden_3d < 0, -1.0, 1.0)

    mant_prod = _mant_product(mant_width, a_mant[:, :, None], b_mant[None, :, :],
                              error_table, with_approx)
    approx_3d = ldexp(mant_prod * sign_3d, approx_expo - bias_r2)

    if with_s2nn2s_opt:
        # scale subnormal contributions back down
        approx_3d = torch.where(a_subnorm[:, :, None], approx_3d / mant_scale, approx_3d)
        approx_3d = torch.where(b_subnorm[None, :, :], approx_3d / mant_scale, approx_3d)
        approx_3d = torch.where(zero_mask_3d, 0.0, approx_3d)
    else:
        # approximate only where both operands and the product are normal;
        # fall back to golden elsewhere
        min_norm_r = ldexp(one, 1 - bias_r2)
        norm_mask_3d = ((a_expo[:, :, None] > 0) & (b_expo[None, :, :] > 0)
                        & (torch.abs(golden_3d) >= min_norm_r))
        approx_3d = torch.where(norm_mask_3d, approx_3d, golden_3d)

    if quant_btw_mult_accu:
        approx_3d = quantize_exmy(approx_3d, expo_width, mant_width, bias_r2,
                                  clip_of=golden_clip_of)
    return approx_3d


def approx_matmul_golden(A, B, expo_width: int, mant_width: int, bias_a, bias_b,
                         bias_r, error_table, *, with_approx: bool = True,
                         with_s2nn2s_opt: bool = False,
                         sim_hw_add_ofuf: bool = False, with_of_opt: bool = False,
                         with_uf_opt: bool = False, golden_clip_of: bool = False,
                         quant_btw_mult_accu: bool = True, self_check: bool = False):
    """Approximate matmul ``A @ B`` with the v9 simulation pipeline.

    A: (M, K) on the ExMy(bias_a) grid; B: (K, N) on the ExMy(bias_b) grids;
    bias_a scalar, bias_b / bias_r scalar or (N,); error_table (2^M, 2^M)
    from ``luts.get_error_table``. Returns (M, N) float32.

    ``with_of_opt``/``with_uf_opt`` act only with ``sim_hw_add_ofuf``, as in
    the JAX package.
    """
    del with_of_opt, with_uf_opt
    if sim_hw_add_ofuf:
        raise NotImplementedError(f"sim_hw_add_ofuf (integer-domain OF/UF adder) {_LATER}")
    if self_check:
        raise NotImplementedError(f"self_check statistics {_LATER}")
    return approx_products(
        A, B, expo_width, mant_width, bias_a, bias_b, bias_r, error_table,
        with_approx=with_approx, with_s2nn2s_opt=with_s2nn2s_opt,
        golden_clip_of=golden_clip_of, quant_btw_mult_accu=quant_btw_mult_accu,
    ).sum(dim=1)


def approx_matmul_golden_v6(*args, **kwargs):
    """The v6 integer-domain oracle."""
    raise NotImplementedError(f"approx_matmul_golden_v6 {_LATER}")
