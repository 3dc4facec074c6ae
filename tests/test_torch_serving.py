"""The port's continuous batcher and sampling against the JAX package's, at
the Llama spec and configuration of ``tests/test_llama.py`` (helpers shared
with ``test_torch_llama.py``).

* ``ContinuousBatcher`` greedy tokens equal JAX's for the prompts of
  ``tests/test_llama.py::test_continuous_batcher``, under FIXED (einsum
  attention) and under FAST with ``fused_sdpa=True`` (the attention kernels'
  plain versions here; JAX's Pallas kernels in interpret mode). Both
  batchers hold a ``PrefixCache``, which those prompts miss; three prompts
  sharing an 8-token head then follow, the first missing and the other two
  splicing its head (warm admissions: the einsum or K7 path over the slab
  with offsets). Greedy speculative decoding (FIXED) gives JAX's
  ``SpeculativeDecoder`` tokens. At this seed no logit of either run sits
  within the two frameworks' ulps of a tie.
* ``filtered_logits`` equals JAX's for top-k and top-p (inputs with no logit
  near the nucleus threshold, where the two cumsums' last bits could decide).
* Temperature sampling draws from a ``torch.Generator``, not JAX's keys, so
  only its support and its repeatability under one seed are checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_llama import SPEC, JaxSide, T_FAST_FUSED, torch_model

from fp8_quantization_tpu.models.prefix_cache import PrefixCache as JPrefixCache
from fp8_quantization_tpu.models.sampling import SamplingParams as JParams
from fp8_quantization_tpu.models.sampling import filtered_logits as j_filtered
from fp8_quantization_tpu.models.serving import ContinuousBatcher as JBatcher
from fp8_quantization_tpu.models.speculative import SpeculativeDecoder as JDecoder
from fp8_quantization_tpu.quant.sites import QuantPhase as JPhase
from fp8_quantization_tpu_torch.models import sampling
from fp8_quantization_tpu_torch.models.llama import LlamaSpec
from fp8_quantization_tpu_torch.models.prefix_cache import PrefixCache
from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher, _pad_to_bucket
from fp8_quantization_tpu_torch.models.speculative import SpeculativeDecoder
from fp8_quantization_tpu_torch.quant.sites import FIXED

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

# tests/test_llama.py::test_continuous_batcher's prompts and token budgets
PROMPTS = [([1, 2, 3, 4, 5], 6), ([7, 8, 9], 4)]
REUSE = ([11, 12], 3)


def shared_head_prompts(seed=5, tails=(3, 6, 1)):
    """Prompts of one shared 8-token head and tails of the given lengths:
    each fits one 16-token bucket and every hit is at 8 tokens (a prefix
    cache of bucket 4), so each JAX prefill compiles once."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, SPEC["vocab_size"], 8).tolist()
    return [shared + rng.integers(0, SPEC["vocab_size"], n).tolist() for n in tails]


SHARED = shared_head_prompts()


@pytest.fixture(scope="module")
def jax_side():
    rng = np.random.default_rng(10)
    return JaxSide(rng.integers(0, SPEC["vocab_size"], size=(2, 12)).astype(np.int32))


def _serve(batcher):
    """test_continuous_batcher's schedule: two prompts in three slots, run
    to completion, retire, then reuse a freed slot."""
    slots = [batcher.admit(p, max_new_tokens=n) for p, n in PROMPTS]
    assert slots == [0, 1] and batcher.free == [2]
    batcher.run_to_completion()
    outs = [batcher.retire(s) for s in slots]
    assert sorted(batcher.free) == [0, 1, 2]
    reused = batcher.admit(REUSE[0], max_new_tokens=REUSE[1])
    batcher.run_to_completion()
    return outs + [batcher.retire(reused)], reused


def _serve_shared(batcher, new=5):
    """``SHARED`` admitted together into the three free slots."""
    slots = [batcher.admit(p, max_new_tokens=new) for p in SHARED]
    batcher.run_to_completion()
    return [batcher.retire(s) for s in slots]


@pytest.mark.parametrize("fused", [False, True], ids=["fixed_einsum", "fast_fused"])
def test_batcher_tokens_equal_jax(jax_side, fused):
    j = jax_side
    if fused:
        variables, j_qp, t_qp = j.cached, JPhase(phase="fixed", fast=True,
                                                 fused_sdpa=True), T_FAST_FUSED
    else:
        variables, j_qp, t_qp = j.calibrated, JPhase(), FIXED
    j_pc, pc = JPrefixCache(bucket=4), PrefixCache(bucket=4)
    j_batcher = JBatcher(j.model, variables, j.spec, slots=3, qp=j_qp, prefix_cache=j_pc)
    want, _ = _serve(j_batcher)
    want_shared = _serve_shared(j_batcher)
    batcher = ContinuousBatcher(torch_model(variables), LlamaSpec(**SPEC), slots=3, qp=t_qp,
                                prefix_cache=pc)
    got, reused = _serve(batcher)
    assert got == want
    assert [len(g) for g in got] == [6, 4, 3] and reused == 2
    assert batcher.cache.length.tolist() == [0, 0, 0]
    assert _serve_shared(batcher) == want_shared
    # PROMPTS and REUSE miss; SHARED misses once, then hits twice at 8
    assert (pc.misses, pc.hits) == (j_pc.misses, j_pc.hits) == (4, 2)


def test_greedy_speculation_equals_jax(jax_side):
    """JAX's ``SpeculativeDecoder`` (a self-draft, FIXED) on ``SHARED``: the
    port's plain batcher, its speculative batcher with a self-draft (every
    proposal accepted: decode and verify take one einsum route) and its
    ``SpeculativeDecoder`` give JAX's tokens."""
    j = jax_side
    spec = LlamaSpec(**SPEC)
    model = torch_model(j.calibrated)
    decoder = JDecoder(j.model, j.calibrated, j.spec, j.model, j.calibrated, j.spec, k=4)
    want = [decoder.generate(p, max_new_tokens=7)[0] for p in SHARED]
    assert _serve_shared(ContinuousBatcher(model, spec, slots=3), new=7) == want
    batcher = ContinuousBatcher(model, spec, slots=3, draft_model=model, draft_spec=spec,
                                spec_k=4)
    assert _serve_shared(batcher, new=7) == want
    assert batcher.proposed > 0 and batcher.acceptance_rate == 1.0
    ours = SpeculativeDecoder(model, spec, model, spec, k=4)
    assert [ours.generate(p, max_new_tokens=7)[0] for p in SHARED] == want


def test_batched_generation_equals_solo(jax_side):
    model = torch_model(jax_side.cached)
    batched = ContinuousBatcher(model, LlamaSpec(**SPEC), slots=3, qp=T_FAST_FUSED)
    slots = [batched.admit(p, max_new_tokens=n) for p, n in PROMPTS]
    batched.run_to_completion()
    together = [batched.retire(s) for s in slots]
    for (prompt, n), want in zip(PROMPTS, together):
        solo = ContinuousBatcher(model, LlamaSpec(**SPEC), slots=1, qp=T_FAST_FUSED)
        s = solo.admit(prompt, max_new_tokens=n)
        solo.run_to_completion()
        assert solo.retire(s) == want


def test_admission_limits_and_later_slices(jax_side):
    model = torch_model(jax_side.calibrated)
    spec = LlamaSpec(**SPEC)
    batcher = ContinuousBatcher(model, spec, slots=1)
    with pytest.raises(ValueError, match="max_seq"):
        batcher.admit(list(range(49)))
    batcher.admit([1, 2])
    with pytest.raises(RuntimeError, match="no free slots"):
        batcher.admit([3])
    assert (_pad_to_bucket(1), _pad_to_bucket(16), _pad_to_bucket(17)) == (16, 16, 32)
    # the mesh batcher, once a later slice, is ported (its tests are in
    # test_torch_parallel_serving.py): a mesh whose data axis does not
    # divide the slots raises, as the JAX batcher does
    from fp8_quantization_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="must divide over the data axis"):
        ContinuousBatcher(model, spec, slots=1, mesh=make_mesh(data=2, devices=["cpu"] * 2))
    # prefix caching and speculative decoding are ported (their parity tests
    # are in test_torch_prefix_spec.py): both construct, with their own state
    pc = PrefixCache(bucket=4)
    cached = ContinuousBatcher(model, spec, slots=2, prefix_cache=pc)
    assert cached.prefix_cache is pc and cached.draft is None and cached.draft_cache is None
    spec_b = ContinuousBatcher(model, spec, slots=2, draft_model=model, draft_spec=spec, spec_k=3)
    assert spec_b.draft is model and spec_b.spec_k == 3 and spec_b.acceptance_rate == 0.0
    assert spec_b.draft_cache.k.shape == spec_b.cache.k.shape
    assert spec_b.draft_cache.k.data_ptr() != spec_b.cache.k.data_ptr()


@pytest.mark.parametrize("params", [dict(temperature=0.7, top_k=5),
                                    dict(temperature=1.3, top_p=0.8),
                                    dict(temperature=1.0, top_k=12, top_p=0.5)],
                         ids=["top_k", "top_p", "top_k_top_p"])
def test_filtered_logits_equal_jax(params):
    rng = np.random.default_rng(3)
    # distinct logits well apart, so no cumulative mass sits at the threshold
    logits = (rng.permutation(64).reshape(1, 64) * 0.37 + rng.normal(size=(4, 64)) * 0.01)
    logits = logits.astype(np.float32)
    want = np.asarray(j_filtered(jnp.asarray(logits), JParams(**params)))
    got = sampling.filtered_logits(torch.from_numpy(logits),
                                   sampling.SamplingParams(**params)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=1e-6)
    probs = sampling.filtered_probs(torch.from_numpy(logits), sampling.SamplingParams(**params))
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_greedy_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [2.0, 2.0, 2.0, 2.0]])
    assert sampling.sample_tokens(logits, sampling.GREEDY).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)).tolist() == [1, 0]


def test_temperature_sampling_stays_in_support_and_repeats():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    params = sampling.SamplingParams(temperature=0.9, top_k=4)
    support = torch.isfinite(sampling.filtered_logits(logits, params))
    draws = [sampling.sample_tokens(logits, params, torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert bool(support.gather(1, draws[0][:, None]).all())
    assert len(set(draws[0].tolist())) > 4     # not collapsed onto the argmax
    with pytest.raises(ValueError, match="Generator"):
        sampling.sample_tokens(logits, params)


def test_batcher_sampling_repeats_under_one_seed(jax_side):
    model = torch_model(jax_side.calibrated)
    params = sampling.SamplingParams(temperature=1.0, top_p=0.9)
    runs = []
    for _ in range(2):
        batcher = ContinuousBatcher(model, LlamaSpec(**SPEC), slots=2, sampling=params,
                                    seed=5)
        s = batcher.admit([1, 2, 3], max_new_tokens=6)
        batcher.run_to_completion()
        runs.append(batcher.retire(s))
    assert runs[0] == runs[1] and len(runs[0]) == 6
    assert all(0 <= t < SPEC["vocab_size"] for t in runs[0])
