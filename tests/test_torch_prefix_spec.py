"""The port's prefix cache and speculative decoding: the pieces against the
JAX package's, and the serving invariants on the port alone (a tiny torch
forward costs milliseconds). ``test_torch_serving.py`` holds the warm and
speculative batchers' tokens to JAX's batcher and ``SpeculativeDecoder`` on
the same prompts (``SHARED``: an 8-token head and short tails).

* ``PrefixCache``: the same ``store``/``lookup`` sequence gives the same
  lengths, slabs, LRU order and ``hits``/``misses`` as JAX's (host logic,
  exact); stored entries are copies.
* ``spec_accept`` on the same drafts, distributions and uniforms gives
  JAX's accept count and accepted prefix (exact: the comparisons are the
  same f32 divisions); its first-token law equals p by Monte Carlo at the
  sample count and bound of JAX's ``test_first_token_law_is_exactly_p``.
  ``filtered_probs`` equals JAX's within ``rtol=1e-6`` (two softmaxes).
* On the port alone, with models at ``tests/test_llama.py``'s spec and FP8
  configuration calibrated by the port (``calibrate_llama``): warm
  admissions give the cold ones' tokens and slot slabs bit for bit under
  FIXED (einsum), FAST+fused (K7's plain version over the slab with
  offsets) and PACKED+packed_kv+fused (uint8 slabs); a padded remainder
  that would spill past ``max_seq`` takes the cold path. Greedy speculation
  under FIXED, where the draft decodes and the (k+1)-token verify take one
  einsum route, gives the plain batcher's tokens with any draft, and a
  self-draft accepts every proposal, on cold and on warm admissions; also
  staggered admissions, the EOS cut mid-round, the near-capacity finish and
  packed_kv on target and draft. (Under FAST+fused the decodes run K6's
  order and the verify K7's, so a self-draft's acceptance may fall below
  1; the card's runs report it.) Stochastic runs draw from a
  ``torch.Generator``, not JAX's keys, so they are held to their laws: every
  token in the support, the same tokens under one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_llama import SPEC, T_FAST_FUSED, T_PACKED_FUSED, qc
from test_torch_serving import SHARED

from fp8_quantization_tpu.models.prefix_cache import PrefixCache as JPrefixCache
from fp8_quantization_tpu.models.sampling import SamplingParams as JParams
from fp8_quantization_tpu.models.sampling import filtered_probs as j_filtered_probs
from fp8_quantization_tpu.models.speculative import spec_accept as j_spec_accept
from fp8_quantization_tpu_torch import config as tc
from fp8_quantization_tpu_torch.models import sampling
from fp8_quantization_tpu_torch.models.llama import KVCache, LlamaSpec, QuantizedLlama
from fp8_quantization_tpu_torch.models.prefix_cache import PrefixCache
from fp8_quantization_tpu_torch.models.serving import (
    ContinuousBatcher,
    calibrate_llama,
    pack_llama,
)
from fp8_quantization_tpu_torch.models.speculative import SpeculativeDecoder, spec_accept
from fp8_quantization_tpu_torch.quant.sites import FIXED

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

T_SPEC = LlamaSpec(**SPEC)
# a draft narrower than the target (tests/test_spec_batcher.py's TINY):
# greedy output must not depend on it
DRAFT_SPEC = LlamaSpec(vocab_size=SPEC["vocab_size"], hidden_size=16, num_layers=1,
                       num_heads=2, num_kv_heads=1, mlp_dim=32,
                       max_seq_len=SPEC["max_seq_len"])
K = 4


PROMPTS = SHARED
NEW = 7


def port_model(spec, seed, packed_kv=False):
    """Seeded weights and ``calibrate_llama`` (ESTIMATE, then the FAST weight
    cache), on the port alone."""
    model = QuantizedLlama(qc(tc), spec, packed_kv=packed_kv,
                           generator=torch.Generator().manual_seed(seed))
    calibrate_llama(model, np.random.default_rng(seed).integers(0, spec.vocab_size, (2, 12)))
    return model


@pytest.fixture(scope="module")
def models():
    """The target in FIXED/FAST (bf16 KV), in PACKED (packed and stripped,
    uint8 KV), and a narrower draft."""
    packed = port_model(T_SPEC, 0)
    pack_llama(packed)
    return dict(target=port_model(T_SPEC, 0), packed=packed, draft=port_model(DRAFT_SPEC, 1))


def _serve(batcher, prompts, new=NEW, sequential=False):
    """Admit every prompt (or, ``sequential``, one at a time, run each to
    completion before the next); returns the tokens and each prompt's
    slot slabs as they stood right after its admission."""
    slabs, outs, slots = [], [], []
    for p in prompts:
        slot = batcher.admit(p, max_new_tokens=new)
        slabs.append((batcher.cache.k[:, slot, :len(p)].clone(),
                      batcher.cache.v[:, slot, :len(p)].clone()))
        slots.append(slot)
        if sequential:
            batcher.run_to_completion()
            outs.append(batcher.retire(slot))
    if not sequential:
        batcher.run_to_completion()
        outs = [batcher.retire(s) for s in slots]
    return outs, slabs


# ---------------------------------------------------------------------------
# PrefixCache: the same calls, the same answers


def _slab(layers, n, heads=2, d=8, offset=0.0):
    return np.arange(layers * n * heads * d, dtype=np.float32).reshape(
        layers, 1, n, heads, d) + offset


# (constructor keywords, calls): ("store", prompt, slab length) or
# ("lookup", prompt); JAX's test_lookup_longest_and_lru,
# test_store_cap_protects_shared_entries and test_shared_prefix_with_unique_tails
CACHE_SCRIPTS = {
    "longest_and_lru": (dict(max_tokens=64, bucket=4), [
        ("store", list(range(8)), 32), ("store", list(range(16)), 32),
        ("lookup", list(range(16)) + [99]), ("lookup", list(range(8)) + [1, 2]),
        ("lookup", list(range(8))), ("lookup", [7, 7, 7]),
        ("store", [5] * 48 + list(range(3)), 48), ("lookup", list(range(16)) + [1]),
        ("lookup", [5] * 48 + [0])]),
    "store_cap": (dict(max_tokens=64, bucket=4, max_entry_tokens=16), [
        ("store", list(range(8)), 64), ("store", list(range(1000, 1064)), 64),
        ("lookup", list(range(8)) + [1]), ("store", list(range(2000, 2030)), 64),
        ("store", list(range(3000, 3020)), 64), ("lookup", list(range(8)) + [1]),
        ("lookup", list(range(1000, 1020)))]),
    "shared_tails": (dict(max_tokens=256, bucket=16), [
        ("store", list(range(100, 132)) + [1, 2, 3, 4], 48),
        ("lookup", list(range(100, 132)) + [9, 9]), ("lookup", list(range(100, 132))),
        ("store", list(range(64)) + list(range(200, 216)), 80),
        ("lookup", list(range(64)) + list(range(300, 316))), ("lookup", list(range(15)))]),
}


@pytest.mark.parametrize("name", list(CACHE_SCRIPTS))
def test_prefix_cache_answers_as_jax(name):
    kwargs, calls = CACHE_SCRIPTS[name]
    ours, theirs = PrefixCache(**kwargs), JPrefixCache(**kwargs)
    assert ours.max_entry_tokens == theirs.max_entry_tokens
    for i, call in enumerate(calls):
        if call[0] == "store":
            slab = _slab(2, call[2], offset=100.0 * i)
            got = ours.store(call[1], torch.from_numpy(slab), torch.from_numpy(-slab))
            want = theirs.store(call[1], jnp.asarray(slab), jnp.asarray(-slab))
            assert got == want, (name, i)
        else:
            got, want = ours.lookup(call[1]), theirs.lookup(call[1])
            assert (got is None) == (want is None), (name, i)
            if got is not None:
                assert got[0] == want[0], (name, i)
                for a, b in zip(got[1:], want[1:]):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert list(ours._entries) == list(theirs._entries), (name, i)
        assert (ours.hits, ours.misses, ours.cached_tokens) == (
            theirs.hits, theirs.misses, theirs.cached_tokens), (name, i)


def test_stored_entries_are_copies():
    """The batcher's cache is written in place: an entry must not change
    when the slab it came from does."""
    pc = PrefixCache(bucket=4)
    slab = torch.ones((2, 1, 8, 2, 4))
    pc.store(list(range(8)), slab, -slab)
    slab.zero_()
    lp, k, v = pc.lookup(list(range(8)) + [1])
    assert lp == 8 and bool((k == 1).all()) and bool((v == -1).all())


# ---------------------------------------------------------------------------
# Warm admission


@pytest.mark.parametrize("mode", ["fixed_einsum", "fast_fused", "packed_kv"])
def test_warm_admission_equals_cold_bit_for_bit(models, mode):
    """Sequential admissions sharing an 8-token head: the first misses and
    the others splice its prefix and prefill their remainder over the slab;
    their tokens and slot slabs equal a cold run's bit for bit."""
    model = models["packed" if mode == "packed_kv" else "target"]
    qp = {"fixed_einsum": FIXED, "fast_fused": T_FAST_FUSED, "packed_kv": T_PACKED_FUSED}[mode]
    cold, cold_slabs = _serve(ContinuousBatcher(model, T_SPEC, slots=2, qp=qp), PROMPTS,
                              sequential=True)
    pc = PrefixCache(bucket=4)
    batcher = ContinuousBatcher(model, T_SPEC, slots=2, qp=qp, prefix_cache=pc)
    warm, warm_slabs = _serve(batcher, PROMPTS, sequential=True)
    assert (pc.misses, pc.hits) == (1, 2)
    assert batcher.cache.k.dtype == (torch.uint8 if mode == "packed_kv" else torch.bfloat16)
    assert warm == cold and all(len(t) == NEW for t in warm)
    for (ck, cv), (wk, wv) in zip(cold_slabs, warm_slabs):
        assert torch.equal(ck, wk) and torch.equal(cv, wv)


def test_warm_admission_overflow_falls_back_to_cold(models):
    """A prefix-cache bucket (4) finer than the serving pad bucket (16): a
    38-token prompt stores its 36-token prefix; a 47-token prompt sharing
    it hits, but its 11-token remainder pads to 16 and would run to 52 of
    48 slots, so it takes the cold path (JAX's
    ``test_warm_admission_overflow_falls_back_to_cold``)."""
    model = models["target"]
    shared = np.random.default_rng(6).integers(0, SPEC["vocab_size"], 36).tolist()
    prompts = [shared + [1, 2], shared + list(range(11))]
    cold, cold_slabs = _serve(ContinuousBatcher(model, T_SPEC, slots=2), prompts, new=1,
                              sequential=True)
    pc = PrefixCache(max_tokens=512, bucket=4, max_entry_tokens=512)
    batcher = ContinuousBatcher(model, T_SPEC, slots=2, prefix_cache=pc)
    chunks = []

    def recording(tokens, cache, qp, chunk_attention=False):
        chunks.append((tokens.shape[1], int(cache.length[0]), chunk_attention))
        return model(tokens, cache, qp, chunk_attention=chunk_attention)

    batcher.model = recording
    warm, warm_slabs = _serve(batcher, prompts, new=1, sequential=True)
    assert warm == cold and pc.hits == 1
    assert chunks == [(48, 0, True), (48, 0, True)]
    for (ck, cv), (wk, wv) in zip(cold_slabs, warm_slabs):
        assert torch.equal(ck, wk) and torch.equal(cv, wv)


# ---------------------------------------------------------------------------
# spec_accept and filtered_probs


def _dists(rng, k, v):
    q = rng.dirichlet(np.ones(v), size=k).astype(np.float32)
    p = rng.dirichlet(np.ones(v), size=k + 1).astype(np.float32)
    return q, p


def _accept_cases():
    """(drafts, q_rows, p_rows, u) batches: random distributions, p == q
    (every draft accepted) and disjoint supports (every draft rejected)."""
    rng = np.random.default_rng(0)
    k, v, n = 4, 6, 64
    cases = {}
    q, p = _dists(rng, k, v)
    drafts = np.stack([[rng.choice(v, p=q[i] / q[i].sum()) for i in range(k)]
                       for _ in range(n)]).astype(np.int32)
    cases["random"] = (drafts, np.broadcast_to(q, (n, k, v)), np.broadcast_to(p, (n, k + 1, v)),
                       rng.random((n, k), dtype=np.float32))
    same = np.concatenate([q, p[:1]])
    cases["p_equals_q"] = (drafts, np.broadcast_to(q, (n, k, v)),
                           np.broadcast_to(same, (n, k + 1, v)),
                           rng.random((n, k), dtype=np.float32))
    qd = np.zeros((k, v), np.float32)
    qd[:, 0] = 1
    pd = np.tile(np.asarray([0, 0.25, 0.25, 0.5, 0, 0], np.float32), (k + 1, 1))
    cases["disjoint"] = (np.zeros((n, k), np.int32), np.broadcast_to(qd, (n, k, v)),
                         np.broadcast_to(pd, (n, k + 1, v)), rng.random((n, k), dtype=np.float32))
    return cases


@pytest.mark.parametrize("name", ["random", "p_equals_q", "disjoint"])
def test_spec_accept_matches_jax(name):
    drafts, q, p, u = _accept_cases()[name]
    accept = jax.jit(jax.vmap(j_spec_accept))
    keys = jax.random.split(jax.random.key(0), len(drafts))
    out, m = accept(jnp.asarray(drafts), jnp.asarray(q), jnp.asarray(p), jnp.asarray(u), keys)
    out, m = np.asarray(out), np.asarray(m)
    t_out, t_m = spec_accept(torch.from_numpy(drafts), torch.from_numpy(q.copy()),
                             torch.from_numpy(p.copy()), torch.from_numpy(u),
                             torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(t_m.numpy(), m)
    for row, (ours, theirs, mm) in enumerate(zip(t_out.numpy(), out, m)):
        np.testing.assert_array_equal(ours[:mm], theirs[:mm], err_msg=str(row))
    support = p[np.arange(len(m)), m] > 0
    assert bool(support[np.arange(len(m)), t_out.numpy()[np.arange(len(m)), m]].all())
    expect_m = {"random": None, "p_equals_q": drafts.shape[1], "disjoint": 0}[name]
    if expect_m is not None:
        assert bool((t_m == expect_m).all())
    else:
        assert 0 < t_m.float().mean() < drafts.shape[1]


def test_first_token_law_is_exactly_p():
    """JAX's test at its sample count and bound, on the port's function:
    drafts drawn from q, then ``spec_accept``; the first emitted token's
    histogram is p_rows[0]; given the first draft accepted, the second's is
    p_rows[1]."""
    rng = np.random.default_rng(0)
    k, v, n = 3, 5, 60000
    q, p = _dists(rng, k, v)
    gen = torch.Generator().manual_seed(0)
    qt, pt = torch.from_numpy(q), torch.from_numpy(p)
    drafts = torch.multinomial(qt, n, replacement=True, generator=gen).T     # (n, k)
    u = torch.rand((n, k), generator=gen)
    out, m = spec_accept(drafts, qt.expand(n, k, v), pt.expand(n, k + 1, v), u, gen)
    hist = np.bincount(out[:, 0].numpy(), minlength=v) / n
    np.testing.assert_allclose(hist, p[0], atol=0.012)
    second = out[m >= 1, 1].numpy()
    np.testing.assert_allclose(np.bincount(second, minlength=v) / second.size, p[1], atol=0.02)


@pytest.mark.parametrize("params", [dict(temperature=0.8, top_k=16),
                                    dict(temperature=1.1, top_p=0.7)], ids=["top_k", "top_p"])
def test_filtered_probs_equal_jax(params):
    rng = np.random.default_rng(8)
    logits = (rng.permutation(64).reshape(1, 64) * 0.37
              + rng.normal(size=(3, 64)) * 0.01).astype(np.float32)
    want = np.asarray(j_filtered_probs(jnp.asarray(logits), JParams(**params)))
    got = sampling.filtered_probs(torch.from_numpy(logits),
                                  sampling.SamplingParams(**params)).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Speculative decoding


def _spec(model, draft, draft_spec, **kw):
    return ContinuousBatcher(model, T_SPEC, slots=3, draft_model=draft, draft_spec=draft_spec,
                             spec_k=K, **kw)


def test_greedy_speculation_equals_plain(models):
    """Three prompts served together: the speculative batcher with a narrow
    draft and with a self-draft, and ``SpeculativeDecoder`` for each prompt,
    give the plain batcher's tokens."""
    target, draft = models["target"], models["draft"]
    plain, _ = _serve(ContinuousBatcher(target, T_SPEC, slots=3), PROMPTS)
    narrow = _spec(target, draft, DRAFT_SPEC)
    assert _serve(narrow, PROMPTS)[0] == plain
    assert 0 < narrow.proposed and narrow.accepted < narrow.proposed
    own = _spec(target, target, T_SPEC)
    assert _serve(own, PROMPTS)[0] == plain and own.acceptance_rate == 1.0
    for prompt, tokens in zip(PROMPTS, plain):
        decoder = SpeculativeDecoder(target, T_SPEC, draft, DRAFT_SPEC, k=K)
        out, stats = decoder.generate(prompt, max_new_tokens=NEW)
        assert out == tokens and stats.target_steps > 0
        assert stats.proposed == K * stats.target_steps


def test_self_draft_accepts_everything_on_warm_admissions(models):
    """The dense batcher prefills the draft cold over the whole prompt on a
    warm admission too, so a self-draft's cache holds the target's rows and
    it accepts every proposal (the paged batcher's warm-draft fault would
    fail here)."""
    target = models["target"]
    plain, _ = _serve(ContinuousBatcher(target, T_SPEC, slots=3), PROMPTS, sequential=True)
    pc = PrefixCache(bucket=4)
    batcher = _spec(target, target, T_SPEC, prefix_cache=pc)
    rows = []
    for p in PROMPTS:
        slot = batcher.admit(p, max_new_tokens=NEW)
        rows.append(all(torch.equal(c[:, slot, :len(p)], d[:, slot, :len(p)])
                        for c, d in ((batcher.cache.k, batcher.draft_cache.k),
                                     (batcher.cache.v, batcher.draft_cache.v))))
        batcher.run_to_completion()
        assert batcher.retire(slot) == plain[len(rows) - 1]
    assert (pc.misses, pc.hits) == (1, 2) and all(rows)
    assert batcher.acceptance_rate == 1.0 and batcher.proposed > 0


def test_staggered_admission(models):
    """A slot admitted after a round joins the batched rounds; each slot's
    tokens equal its solo run's."""
    target, draft = models["target"], models["draft"]
    solo = [_serve(_spec(target, draft, DRAFT_SPEC), [p])[0][0] for p in PROMPTS]
    batcher = _spec(target, draft, DRAFT_SPEC)
    slots = [batcher.admit(p, max_new_tokens=NEW) for p in PROMPTS[:2]]
    assert batcher.step()
    slots.append(batcher.admit(PROMPTS[2], max_new_tokens=NEW))
    batcher.run_to_completion()
    assert [batcher.retire(s) for s in slots] == solo
    assert batcher.cache.length.tolist() == batcher.draft_cache.length.tolist() == [0, 0, 0]


def test_eos_cuts_mid_round(models):
    """An EOS emitted inside an accepted run stops the slot at once: the
    tokens up to and including the first EOS of the plain decode. A
    self-draft accepts every proposal, so round r emits tokens
    1 + (r-1)(k+1) .. r(k+1); the EOS is taken where it is not a round's
    last token."""
    target = models["target"]
    for prompt in PROMPTS:
        ref = _serve(ContinuousBatcher(target, T_SPEC, slots=1), [prompt], new=12)[0][0]
        cut = next((i for i in range(2, len(ref))
                    if ref[i] not in ref[:i] and i % (K + 1) != 0), None)
        if cut is not None:
            break
    assert cut is not None, "no greedy sequence with a late first occurrence"
    batcher = ContinuousBatcher(target, T_SPEC, slots=1, eos_token=ref[cut],
                                draft_model=target, draft_spec=T_SPEC, spec_k=K)
    got = _serve(batcher, [prompt], new=12)[0][0]
    assert got == ref[:cut + 1]
    rounds = batcher.proposed // K
    assert batcher.acceptance_rate == 1.0 and 1 + rounds * (K + 1) > len(got)


def test_near_capacity_slot_finishes_early(models):
    """A slot within k+1 tokens of ``max_seq`` finishes instead of running
    a round past the slab."""
    target, draft = models["target"], models["draft"]
    batcher = ContinuousBatcher(target, T_SPEC, slots=1, draft_model=draft,
                                draft_spec=DRAFT_SPEC, spec_k=K)
    prompt = np.random.default_rng(0).integers(0, SPEC["vocab_size"], 30).tolist()
    got = _serve(batcher, [prompt], new=60)[0][0]
    s = T_SPEC.max_seq_len
    assert len(prompt) + len(got) + K + 1 > s and len(prompt) + len(got) <= s
    plain = _serve(ContinuousBatcher(target, T_SPEC, slots=1), [prompt], new=len(got))[0][0]
    assert got == plain


def test_packed_kv_on_target_and_draft():
    """uint8 KV slabs on both models under FIXED (tests/test_spec_batcher.py's
    ``test_composes_with_packed_kv``): rollback works on byte slabs and the
    tokens equal the non-speculative packed batcher's."""
    target = port_model(T_SPEC, 0, packed_kv=True)
    draft = port_model(DRAFT_SPEC, 1, packed_kv=True)
    want, _ = _serve(ContinuousBatcher(target, T_SPEC, slots=3), PROMPTS)
    batcher = _spec(target, draft, DRAFT_SPEC)
    assert batcher.cache.k.dtype == batcher.draft_cache.k.dtype == torch.uint8
    assert _serve(batcher, PROMPTS)[0] == want


def test_stochastic_speculation_stays_in_support_and_repeats(models):
    """Temperature sampling with top-k through ``spec_accept``: every token
    inside the target's top-k, the same tokens under one seed, other tokens
    under another, and a narrow draft gets some proposals rejected."""
    target, draft = models["target"], models["draft"]
    params = sampling.SamplingParams(temperature=0.8, top_k=16)

    def run(seed):
        batcher = _spec(target, draft, DRAFT_SPEC, sampling=params, seed=seed)
        return _serve(batcher, PROMPTS)[0], batcher

    (a, b1), (b, _), (c, _) = run(11), run(11), run(12)
    assert a == b and a != c
    assert all(len(t) == NEW for t in a)
    assert 0 < b1.proposed and b1.accepted < b1.proposed
    decoder = SpeculativeDecoder(target, T_SPEC, target, T_SPEC, k=K, sampling=params, seed=3)
    out, stats = decoder.generate(PROMPTS[0], max_new_tokens=NEW)
    assert len(out) == NEW and stats.acceptance_rate > 0
    # every token of the first run lies in the target's top-k after its context
    for prompt, tokens in zip(PROMPTS, a):
        seq = torch.tensor([prompt + tokens])
        with torch.no_grad():
            logits, _ = target(seq, KVCache.zeros(T_SPEC, 1, SPEC["max_seq_len"]), FIXED)
        top = torch.topk(logits[0, len(prompt) - 1:-1], 16, dim=-1).indices
        assert bool((top == torch.tensor(tokens)[:, None]).any(-1).all())


def test_mesh_decoder_is_a_later_slice(models):
    target = models["target"]
    with pytest.raises(NotImplementedError, match="later slice"):
        SpeculativeDecoder(target, T_SPEC, target, T_SPEC, mesh="mesh")
    with pytest.raises(NotImplementedError, match="later slice"):
        _spec(target, target, T_SPEC, mesh="mesh")
