"""The port's ring attention and the Llama ring prefill against the JAX
package's, the JAX side on its 8-device virtual CPU mesh
(``tests/conftest.py``), the port's on a virtual mesh of eight CPU devices.

The cases are ``tests/test_ring_attention.py``'s, on the same shapes and
inputs, each also held against the JAX function itself: ``ring_attention``
to JAX's ``ring_attention`` and to the port's ``full_attention`` at JAX's
``rtol = atol = 2e-5``; the Llama ring prefill's logits to the dense prefill
at ``2e-4`` with an equal KV cache, and to JAX's ring prefill at the
Llama tests' ``1e-4`` (``tests/test_torch_llama.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.parallel import make_mesh as j_make_mesh
from fp8_quantization_tpu.parallel.ring_attention import full_attention as j_full
from fp8_quantization_tpu.parallel.ring_attention import ring_attention as j_ring
from fp8_quantization_tpu_torch.parallel import make_mesh
from fp8_quantization_tpu_torch.parallel.ring_attention import full_attention, ring_attention

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

TOL = dict(rtol=2e-5, atol=2e-5)
CPU8 = [torch.device("cpu")] * 8

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _qkv(rng, b=2, s=64, h=4, h_kv=None, d=8):
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h_kv or h, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h_kv or h, d)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_full(rng, causal):
    q, k, v = _qkv(rng)
    out = ring_attention(*_t(q, k, v), make_mesh(data=8, model=1, devices=CPU8), causal=causal)
    np.testing.assert_allclose(out.numpy(), full_attention(*_t(q, k, v), causal=causal).numpy(),
                               **TOL)
    jmesh = j_make_mesh(data=8, model=1)
    jout = jax.jit(lambda q, k, v: j_ring(q, k, v, jmesh, causal=causal))(q, k, v)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(full_attention(*_t(q, k, v), causal=causal).numpy(),
                               np.asarray(j_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 causal=causal)), **TOL)


def test_ring_gqa_heads(rng):
    """Grouped-query attention: 8 q heads over 2 kv heads."""
    q, k, v = _qkv(rng, h=8, h_kv=2)
    out = ring_attention(*_t(q, k, v), make_mesh(data=8, model=1, devices=CPU8), causal=True)
    np.testing.assert_allclose(out.numpy(), full_attention(*_t(q, k, v), causal=True).numpy(),
                               **TOL)
    jout = j_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  j_make_mesh(data=8, model=1), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_ring_device_count_invariance(rng):
    """The result does not depend on how many devices share the sequence."""
    q, k, v = _qkv(rng, s=32)
    outs = [ring_attention(*_t(q, k, v), make_mesh(data=n, model=1, devices=CPU8[:n]),
                           causal=True).numpy() for n in (2, 4, 8)]
    np.testing.assert_allclose(outs[0], outs[1], **TOL)
    np.testing.assert_allclose(outs[1], outs[2], **TOL)


def test_ring_rejects_bad_shapes(rng):
    mesh = make_mesh(data=8, model=1, devices=CPU8)
    with pytest.raises(ValueError):
        ring_attention(*_t(*_qkv(rng, s=60)), mesh)            # 60 % 8 != 0
    with pytest.raises(ValueError):
        ring_attention(*_t(*_qkv(rng, h=6, h_kv=4)), mesh)


def test_ring_long_context_row_sums(rng):
    """Causal rows are proper distributions: uniform V gives exactly V."""
    b, s, h, d = 1, 128, 2, 4
    q = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
    v = torch.full((b, s, h, d), 3.5)
    out = ring_attention(q, k, v, make_mesh(data=8, model=1, devices=CPU8), causal=True)
    np.testing.assert_allclose(out.numpy(), 3.5, rtol=1e-5)


def test_llama_ring_prefill_matches_dense(rng):
    """``QuantizedLlama(ring_spec=...)``'s prefill equals the cache-gather
    prefill, including the KV cache it leaves behind (decode continues
    identically), and JAX's ring prefill on the same variables."""
    from test_torch_llama import numpy_tree, qc

    from fp8_quantization_tpu import config as jc
    from fp8_quantization_tpu.models.llama import KVCache as JCache
    from fp8_quantization_tpu.models.llama import LlamaSpec as JSpec
    from fp8_quantization_tpu.models.llama import QuantizedLlama as JLlama
    from fp8_quantization_tpu.quant import ESTIMATE as J_ESTIMATE
    from fp8_quantization_tpu.quant import FIXED as J_FIXED
    from fp8_quantization_tpu_torch import config as tc
    from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
    from fp8_quantization_tpu_torch.models.llama import KVCache, LlamaSpec, QuantizedLlama
    from fp8_quantization_tpu_torch.quant.sites import FIXED

    spec = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                mlp_dim=64, max_seq_len=32)
    jspec = JSpec(**spec)
    jmesh = j_make_mesh(data=8, model=1)
    base = JLlama(qc=qc(jc), spec=jspec)
    ringed = JLlama(qc=qc(jc), spec=jspec, ring_spec=(jmesh, "data"))
    tokens = rng.integers(0, 64, size=(2, 16)).astype(np.int32)
    cache0 = JCache.zeros(jspec, 2, jspec.max_seq_len)
    variables = jax.jit(base.init, static_argnums=3)(jax.random.key(0), tokens, cache0,
                                                     J_ESTIMATE)
    _, ups = jax.jit(lambda v: base.apply(v, tokens, cache0, J_ESTIMATE,
                                          mutable=["quant", "quant_est"]))(variables)
    variables = {**variables, **ups}
    j_logits, j_cache = jax.jit(lambda v: ringed.apply(v, tokens, cache0, J_FIXED))(variables)

    mesh = make_mesh(data=8, model=1, devices=CPU8)
    model = QuantizedLlama(qc(tc), LlamaSpec(**spec))
    model.load_state_dict(from_jax_variables(numpy_tree(variables)), strict=True)
    t_tokens = torch.from_numpy(tokens.astype(np.int64))
    with torch.no_grad():
        logits_d, cache_d = model(t_tokens, KVCache.zeros(model.spec, 2, 32), FIXED)
        model.ring_spec = (mesh, "data")
        logits_r, cache_r = model(t_tokens, KVCache.zeros(model.spec, 2, 32), FIXED)
        model.ring_spec = None
    np.testing.assert_allclose(logits_r.numpy(), logits_d.numpy(), rtol=2e-4, atol=2e-4)
    assert torch.equal(cache_r.k, cache_d.k) and torch.equal(cache_r.v, cache_d.v)
    np.testing.assert_allclose(logits_r.numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(cache_r.k[0].float().numpy(),
                                  np.asarray(j_cache.k[0], np.float32))

    # decode one token from each cache with the plain model: the same path
    nxt = torch.from_numpy(rng.integers(0, 64, size=(2, 1)))
    with torch.no_grad():
        ld, _ = model(nxt, cache_d, FIXED)
        lr, _ = model(nxt, cache_r, FIXED)
    np.testing.assert_allclose(lr.numpy(), ld.numpy(), rtol=1e-5, atol=1e-5)
