"""The fused SDPA's (K7) numerics contract, ``ops/cuda/attention.py::
within_sdpa_contract``, on small seeded tensors on the CPU (no JAX).

The kernel sums ``q k^T`` and ``p v`` on the tensor cores in their own
order, so it is held to the plain version by a bound derived from the
summation order alone. The contract must accept the plain version with its
sums in another legal order (each score over d descending, ``p v`` over keys
descending), in f32, in bf16 and with the requant epilogue, and must reject
each of five faults a kernel could have: a causal mask one key too long, the
wrong kv head for a group of query heads, ``s_valid`` ignored, the
``1/sqrt(D)`` scale missing, and the requant epilogue skipped.
"""

import numpy as np
import pytest
import torch

from fp8_quantization_tpu_torch.ops.cuda import attention as k7

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

# (B, T, S, H, HK, D); D = 16 makes the missing scale exact (q * 4 in bf16)
SHAPE = (2, 24, 24, 4, 2, 16)
RES = (torch.tensor(2.0), torch.tensor(5), 4, 1)


def _operands(seed, shape=SHAPE):
    b, t, s, h, hk, d = shape
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, s, hk, d)).astype(np.float32))
            for _ in range(2))
    return q, k, v


# keyword arguments of the call under the contract, and the output dtype
ACCEPT = {
    "causal": (dict(causal=True), torch.float32),
    "s_valid": (dict(s_valid=13), torch.float32),
    "causal_offsets": (dict(causal=True, offsets=torch.tensor([0, 5], dtype=torch.int32)),
                       torch.float32),
    "bf16_out": (dict(causal=True), torch.bfloat16),
    "requant": (dict(causal=True, res_params=RES), torch.float32),
}


@pytest.mark.parametrize("name", list(ACCEPT))
def test_contract_accepts_another_summation_order(name):
    kw, out_dtype = ACCEPT[name]
    q, k, v = _operands(1)
    ours = k7.fused_sdpa_plain(q, k, v, out_dtype=out_dtype, descending=True, **kw)
    ok, info = k7.within_sdpa_contract(ours, q, k, v, **kw)
    assert ok, info
    same, _ = k7.within_sdpa_contract(k7.fused_sdpa_plain(q, k, v, out_dtype=out_dtype, **kw),
                                      q, k, v, **kw)
    assert same


def test_another_order_is_not_the_same_function_bit_for_bit():
    """The legal reading differs from the plain one in some outputs, and the
    bound holds them with room: the contract is not equality in disguise."""
    q, k, v = _operands(2)
    ours = k7.fused_sdpa_plain(q, k, v, causal=True, descending=True)
    ok, info = k7.within_sdpa_contract(ours, q, k, v, causal=True)
    assert ok and info["steps"] > 0 and 0.0 < info["worst_ratio"] < 1.0


def _faults(q, k, v):
    """(name, output of the faulty computation, contract keywords)."""
    b, d = q.shape[0], q.shape[-1]
    plain = k7.fused_sdpa_plain
    return [
        ("causal mask one key too long",
         plain(q, k, v, causal=True, offsets=torch.ones(b, dtype=torch.int32)),
         dict(causal=True)),
        ("wrong kv head for a group",
         plain(q, k.roll(1, dims=2), v.roll(1, dims=2), causal=True), dict(causal=True)),
        ("s_valid ignored", plain(q, k, v), dict(s_valid=13)),
        ("scale missing", plain(q * float(d) ** 0.5, k, v, causal=True), dict(causal=True)),
        ("requant epilogue skipped", plain(q, k, v, causal=True),
         dict(causal=True, res_params=RES)),
    ]


@pytest.mark.parametrize("fault", range(5))
def test_contract_rejects_a_fault(fault):
    q, k, v = _operands(3)
    name, ours, kw = _faults(q, k, v)[fault]
    ok, info = k7.within_sdpa_contract(ours, q, k, v, **kw)
    assert not ok, (name, info)
