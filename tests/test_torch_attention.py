"""The attention kernels' plain versions against the JAX package's Pallas
kernels, which run in interpret mode on the CPU: the fused SDPA (K7,
``ops/cuda/attention.py::fused_sdpa_plain`` against
``ops/pallas/attention.py::fused_sdpa``) and the decode attention (K6,
``ops/cuda/decode_attention.py::decode_attention_plain`` against
``ops/pallas/decode_attention.py::decode_attention``).

Same numpy inputs on both sides; tolerance ``rtol=atol=2e-3``, the JAX
attention tests' own. Both compute the same function at the same rounding
points (bf16 operands, f32 softmax, bf16 probabilities into an f32 PV); only
the order of the f32 sums differs. The wrappers called with CPU tensors take
the plain versions and launch nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.numerics.codec import pack_exmy as j_pack_exmy
from fp8_quantization_tpu.ops.pallas.attention import fused_sdpa as j_fused_sdpa
from fp8_quantization_tpu.ops.pallas.decode_attention import (
    decode_attention as j_decode_attention,
)
from fp8_quantization_tpu_torch.ops.cuda import attention as k7
from fp8_quantization_tpu_torch.ops.cuda import decode_attention as k6
from fp8_quantization_tpu_torch.ops.cuda.fused_matmul import quantize_block_plain

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

TOL = dict(rtol=2e-3, atol=2e-3)


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(fn_j, fn_t, arrays, j_only=None, **kw):
    """Run the JAX kernel and the port's wrapper on the same numpy arrays;
    ``j_only`` holds the JAX kernel's block sizes, which the port has not."""
    j_out = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw, **(j_only or {})),
                       np.float32)
    t_kw = {k: (torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}
    t_out = fn_t(*(torch.from_numpy(a) for a in arrays), **t_kw)
    return t_out.float().numpy(), j_out


# (B, T, S, H, HK, D, keyword arguments)
SDPA_CASES = {
    "s_valid": (2, 20, 20, 4, 4, 16, dict(s_valid=13)),
    "causal_chunk": (2, 24, 24, 4, 4, 16, dict(causal=True)),
    "causal_slab_offsets": (3, 6, 40, 4, 2, 16,
                            dict(causal=True, offsets=np.array([0, 7, 30], np.int32))),
    "gqa": (2, 16, 16, 8, 2, 16, dict()),
    "block_rows": (1, 40, 40, 2, 1, 8, dict(causal=True, j_only=dict(bq=16))),
}


@pytest.mark.parametrize("name", list(SDPA_CASES))
def test_fused_sdpa_plain_matches_jax(name):
    b, t, s, h, hk, d, kw = SDPA_CASES[name]
    rng = np.random.default_rng(len(name))
    arrays = (_normal(rng, b, t, h, d), _normal(rng, b, s, hk, d), _normal(rng, b, s, hk, d))
    launches = k7.fused_sdpa.launches
    ours, ref = _both(j_fused_sdpa, k7.fused_sdpa, arrays, **kw)
    assert k7.fused_sdpa.launches == launches          # CPU tensors: the plain version
    assert ours.shape == (b, t, h, d) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TOL)


def test_fused_sdpa_plain_bf16_inputs():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_normal(rng, 2, 12, 4, 16)).to(torch.bfloat16)
               for _ in range(3))
    ref = np.asarray(j_fused_sdpa(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                    for x in (q, k, v))), np.float32)
    ours = k7.fused_sdpa(q, k, v, out_dtype=torch.bfloat16)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(k7.fused_sdpa(q, k, v).numpy(), ref, **TOL)


def test_fused_sdpa_plain_requant_epilogue():
    """The epilogue against JAX's, and bit for bit the plain ``quantize_block``
    of the port's own context."""
    rng = np.random.default_rng(6)
    arrays = (_normal(rng, 2, 16, 4, 16), _normal(rng, 2, 16, 2, 16), _normal(rng, 2, 16, 2, 16))
    params = (np.float32(2.0), np.int32(5), np.int32(4), np.int32(1))
    j_out = np.asarray(j_fused_sdpa(*(jnp.asarray(a) for a in arrays), causal=True,
                                    res_params=tuple(jnp.asarray(p) for p in params)))
    t_in = [torch.from_numpy(a) for a in arrays]
    t_params = tuple(torch.tensor(p) for p in params)
    ours = k7.fused_sdpa(*t_in, causal=True, res_params=t_params)
    np.testing.assert_allclose(ours.numpy(), j_out, **TOL)
    ctx = k7.fused_sdpa(*t_in, causal=True)
    assert torch.equal(ours, quantize_block_plain(ctx, *t_params))


def test_fused_sdpa_rejects_what_it_does_not_take():
    q = torch.zeros((1, 4, 3, 8))
    k = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="GQA"):
        k7.fused_sdpa(q, k, k)
    with pytest.raises(ValueError, match="causal"):
        k7.fused_sdpa(q[:, :, :2], k, k, offsets=torch.zeros(1, dtype=torch.int32))


def _slabs(rng, b, s, hk, d, coded, bias=(4, 5)):
    kf, vf = _normal(rng, b, s, hk, d), _normal(rng, b, s, hk, d)
    if not coded:
        return kf, vf, {}
    codes = [np.array(j_pack_exmy(jnp.asarray(x), 3, 4, jnp.int32(bb), clip_of=True))
             for x, bb in zip((kf, vf), bias)]
    return codes[0], codes[1], dict(k_bias=np.int32(bias[0]), v_bias=np.int32(bias[1]),
                                    kv_expo=3, kv_mant=4)


# (B, S, H, HK, D, lengths, bs, coded)
DECODE_CASES = {
    "bf16": (3, 64, 8, 4, 16, [1, 30, 64], 512, False),
    "bf16_s_not_a_block_multiple": (3, 160, 8, 4, 16, [1, 80, 160], 64, False),
    "coded": (2, 96, 8, 2, 16, [32, 96], 64, True),
    "coded_lengths_mid_block": (3, 100, 4, 2, 8, [1, 65, 99], 32, True),
    # lengths on the CUDA kernel's 64-key sub-chunk and 512-key block edges
    "lengths_on_sub_chunk_and_block_edges": (7, 576, 4, 2, 8, [1, 63, 64, 65, 511, 512, 513],
                                             512, False),
}


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_attention_plain_matches_jax(name):
    b, s, h, hk, d, lengths, bs, coded = DECODE_CASES[name]
    rng = np.random.default_rng(len(name))
    k_slab, v_slab, ckw = _slabs(rng, b, s, hk, d, coded)
    j_kw = {k: (jnp.asarray(v) if isinstance(v, np.generic) else v) for k, v in ckw.items()}
    q = _normal(rng, b, h, d)
    lens = np.asarray(lengths, np.int32)
    if not coded:
        j_in = (jnp.asarray(q), jnp.asarray(k_slab, jnp.bfloat16),
                jnp.asarray(v_slab, jnp.bfloat16))
        t_in = (torch.from_numpy(q), torch.from_numpy(k_slab).to(torch.bfloat16),
                torch.from_numpy(v_slab).to(torch.bfloat16))
    else:
        j_in = (jnp.asarray(q), jnp.asarray(k_slab), jnp.asarray(v_slab))
        t_in = (torch.from_numpy(q), torch.from_numpy(k_slab), torch.from_numpy(v_slab))
    ref = np.asarray(j_decode_attention(*j_in, jnp.asarray(lens), bs=bs, **j_kw))
    t_kw = {k: (torch.tensor(v) if isinstance(v, np.generic) else v) for k, v in ckw.items()}
    launches = k6.decode_attention.launches
    ours = k6.decode_attention(*t_in, torch.from_numpy(lens), bs=bs, **t_kw).numpy()
    assert k6.decode_attention.launches == launches
    assert ours.shape == (b, h, d) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, **TOL)


def test_decode_attention_block_size_follows_the_tpu_kernel():
    assert k6.block_size(2048) == 512
    assert k6.block_size(100) == 128
    assert k6.block_size(160, 64) == 64


def test_decode_attention_rejects_what_it_does_not_take():
    q = torch.zeros((2, 4, 8))
    slab = torch.zeros((2, 16, 2, 8), dtype=torch.uint8)
    with pytest.raises(TypeError, match="k_bias"):
        k6.decode_attention(q, slab, slab, torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="lengths"):
        k6.decode_attention(q, slab.to(torch.bfloat16), slab.to(torch.bfloat16),
                            torch.ones(3, dtype=torch.int32))
