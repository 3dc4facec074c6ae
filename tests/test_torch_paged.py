"""The port's paged KV cache (``models/paged_kv.py`` and the paged branch of
``models/llama.py``) against the JAX package's, in ``tests/test_llama.py``'s
FP8 configuration, with pages of 8 tokens as ``tests/test_paged_kv.py`` and
``tests/test_spec_paged.py`` build them. JAX's model is calibrated and
carried across by ``models.bridge`` (``test_torch_llama.JaxSide``) at
``SPEC``'s widths with one layer (``J_SPEC``): each JAX compile traces
every layer, and the file keeps to its time budget that way. The port-only
checks run ``SPEC``'s two layers.

* ``QuantizedLlama`` over a ``PagedKVCache``: a prefill of 8 and four
  decodes through a contiguous and a scrambled page table give JAX's logits
  within its own tolerance (``rtol=atol=1e-5``) and the port's dense logits
  bit for bit (the einsum over a gathered view is the slab's einsum), at
  one layer and at two.
* One JAX ``PagedBatcher`` run, FIXED, with a ``PrefixCache`` and a
  self-draft (``jax_fixed``): three prompts together, a fourth into retired
  pages, then ``HEADED`` one at a time (a miss, then two hits). The port's
  plain paged batcher, its dense batcher and its paged batcher with the
  same prefix cache and self-draft give its tokens; the port's self-draft
  accepts every proposal, on the warm admissions too, where JAX's paged
  batcher prefills the draft with the remainder only (its acceptance is
  printed, not held). Under PACKED with a uint8 pool (``fused_sdpa`` off,
  the einsum route, which both frameworks take for a paged decode) the
  port's paged and dense tokens equal JAX's paged tokens.
* On the port alone: the trash page, the pool's dtype check, the
  allocator, page growth and reuse, pages kept across a rollback and
  released at retire, the near-capacity cut, stochastic speculation, warm
  admissions against cold ones (FIXED and FAST+fused) and prefix entries
  shared with the dense batcher.

JAX compiles one set of jits per batcher, so its batchers are two and every
prompt, cold or remainder, pads to one 16-token bucket.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_llama import SPEC, JaxSide, T_FAST_FUSED, torch_model
from test_torch_prefix_spec import DRAFT_SPEC, port_model

from fp8_quantization_tpu.models.paged_kv import PageAllocator as JAllocator
from fp8_quantization_tpu.models.paged_kv import PagedBatcher as JPaged
from fp8_quantization_tpu.models.paged_kv import PagedKVCache as JPagedCache
from fp8_quantization_tpu.models.prefix_cache import PrefixCache as JPrefixCache
from fp8_quantization_tpu.quant import quantizers as j_quantizers
from fp8_quantization_tpu.quant.sites import QuantPhase as JPhase
from fp8_quantization_tpu_torch.models import sampling
from fp8_quantization_tpu_torch.models.llama import KVCache, LlamaSpec
from fp8_quantization_tpu_torch.models.paged_kv import (
    PageAllocator,
    PagedBatcher,
    PagedKVCache,
    _gather_slot_slabs,
)
from fp8_quantization_tpu_torch.models.prefix_cache import PrefixCache
from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher, pack_llama
from fp8_quantization_tpu_torch.quant.sites import FIXED, QuantPhase

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

T_SPEC = LlamaSpec(**SPEC)
J_SPEC = dict(SPEC, num_layers=1)
PAGE = 8
MAX_PAGES = SPEC["max_seq_len"] // PAGE
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
T_PACKED = QuantPhase(phase="fixed", fast=True, packed=True)
J_PACKED = JPhase(phase="fixed", fast=True, packed=True)
K = 4

# three prompts served together, then a fourth admitted into retired pages
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7, 9]]
LATE = [11, 12, 13, 14]
NEW = 9
# an 8-token head and three tails, served one at a time through a prefix
# cache of bucket 8: the first misses, the others hit at 8
HEAD = np.random.default_rng(3).integers(0, SPEC["vocab_size"], 8).tolist()
HEADED = [HEAD + [1, 2, 3], HEAD + [4, 5], HEAD + [6, 7, 8, 9]]


@pytest.fixture(scope="module")
def jax_side():
    """JAX's model at ``J_SPEC``, calibrated. While the module runs, the JAX
    package's FP8 quantizer is jitted (the function unchanged, as
    ``JaxSide.packed`` jits ``pack_weights``), so each JAX compile reuses
    its traces of the quantizer at a shape instead of tracing every site
    anew: most of a compile's time at this size."""
    rng = np.random.default_rng(10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_quantizers, "quantize_to_fp8_ste",
                   jax.jit(j_quantizers.quantize_to_fp8_ste, static_argnums=(1,)))
        yield JaxSide(rng.integers(0, SPEC["vocab_size"], size=(2, 12)).astype(np.int32),
                      J_SPEC)


@pytest.fixture(scope="module")
def port():
    """Port-made models at two layers: the target (FIXED) and a narrower
    draft."""
    return dict(target=port_model(T_SPEC, 0), draft=port_model(DRAFT_SPEC, 1))


def _table(rows, batch):
    table = np.zeros((batch, MAX_PAGES), np.int32)
    for b, row in enumerate(rows):
        table[b, :len(row)] = row
    return table


def _paged(model, spec=T_SPEC, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("num_pages", 24)
    return PagedBatcher(model, spec, page_size=PAGE, **kw)


def _serve(batcher, prompts=PROMPTS, late=LATE, new=NEW):
    """Admit ``prompts`` together, step to completion and retire them, then
    admit ``late`` into the retired pages."""
    slots = [batcher.admit(p, max_new_tokens=new) for p in prompts]
    batcher.run_to_completion()
    out = [batcher.retire(s) for s in slots]
    if late is not None:
        s = batcher.admit(late, max_new_tokens=new)
        batcher.run_to_completion()
        out.append(batcher.retire(s))
    return out


def _sequential(batcher, prompts, new=6):
    out = []
    for p in prompts:
        s = batcher.admit(p, max_new_tokens=new)
        batcher.run_to_completion()
        out.append(batcher.retire(s))
    return out


def _schedule(batcher):
    """``_serve``, then ``HEADED`` one at a time."""
    return _serve(batcher) + _sequential(batcher, HEADED)


@pytest.fixture(scope="module")
def jax_fixed(jax_side):
    """JAX's paged batcher, FIXED, with a prefix cache (bucket 8) and a
    self-draft, over ``_schedule``: its tokens, acceptance and cache
    counts."""
    j = jax_side
    pc = JPrefixCache(max_tokens=256, bucket=8)
    b = JPaged(j.model, j.calibrated, j.spec, slots=4, num_pages=24, page_size=PAGE,
               prefix_cache=pc, draft_model=j.model, draft_variables=j.calibrated,
               draft_spec=j.spec, spec_k=K)
    return dict(tokens=_schedule(b), acceptance=b.acceptance_rate, accepted=b.accepted,
                proposed=b.proposed, misses=pc.misses, hits=pc.hits)


# ---------------------------------------------------------------------------
# QuantizedLlama over pages


@pytest.mark.parametrize("rows", [[[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]],
                                  [[17, 3, 25, 9, 30, 14], [2, 28, 6, 19, 11, 23]]],
                         ids=["contiguous", "scrambled"])
def test_paged_logits_match_jax_and_dense(jax_side, port, rows):
    """``tests/test_paged_kv.py::test_paged_matches_dense``'s prefill of 8
    and four decodes, FIXED: the port's paged logits against JAX's (one
    layer) and against the port's dense ones (one layer and two)."""
    j = jax_side
    seq = np.random.default_rng(3).integers(0, SPEC["vocab_size"], size=(2, 12))
    table = _table(rows, 2)
    jpaged = JPagedCache.zeros(j.spec, 2, 32, PAGE, MAX_PAGES)._replace(page_table=table)
    for model, spec in ((torch_model(j.calibrated, spec=J_SPEC), LlamaSpec(**J_SPEC)),
                        (port["target"], T_SPEC)):
        paged = PagedKVCache.zeros(spec, 2, 32, PAGE, MAX_PAGES)._replace(
            page_table=torch.from_numpy(table))
        dense = KVCache.zeros(spec, 2, SPEC["max_seq_len"])
        assert paged.page_size == PAGE
        for lo, hi in [(0, 8)] + [(i, i + 1) for i in range(8, 12)]:
            x = seq[:, lo:hi]
            with torch.no_grad():
                lp, paged = model(torch.from_numpy(x), paged, FIXED)
                ld, dense = model(torch.from_numpy(x), dense, FIXED)
            assert torch.equal(lp, ld)
            if spec.num_layers == 1:
                lj, jpaged = j.apply(False, j.calibrated, x.astype(np.int32), jpaged, JPhase())
                np.testing.assert_allclose(lp.numpy(), lj, **LOGIT_TOL)
        assert paged.length.tolist() == [12, 12]
        # the rows live in the mapped pages (JAX's bit for bit), unmapped
        # pages stay zero; page 0 took the writes of nothing here
        k_pages = paged.k_pages.view(torch.int16).numpy()
        if spec.num_layers == 1:
            np.testing.assert_array_equal(k_pages, np.asarray(jpaged.k_pages).view(np.int16))
        used = sorted({p for row in rows for p in row[:2]})
        unused = [p for p in range(32) if p not in used]
        assert all((k_pages[:, p] != 0).any() for p in used)
        assert not (k_pages[:, unused] != 0).any()
        k_view, v_view = _gather_slot_slabs(paged._replace(page_table=paged.page_table[1:]))
        assert torch.equal(k_view[:, 0, :12], dense.k[:, 1, :12])
        assert torch.equal(v_view[:, 0, :12], dense.v[:, 1, :12])


def test_positions_past_the_table_write_to_the_trash_page(port):
    """A chunk running past a slot's table (an idle slot's writes near
    ``max_seq``) lands on page 0, as JAX's scatter drops it, and leaves the
    slot's own pages alone."""
    model = port["target"]
    cache = PagedKVCache.zeros(T_SPEC, 1, 8, PAGE, MAX_PAGES)._replace(
        page_table=torch.from_numpy(_table([[1, 2, 3, 4, 5, 6]], 1)),
        length=torch.tensor([44], dtype=torch.int32))
    with torch.no_grad():
        _, cache = model(torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8]]), cache, FIXED)
    k = cache.k_pages
    assert bool((k[:, 6, 4:] != 0).any()) and bool((k[:, 0, :4] != 0).any())
    assert not bool((k[:, 1:6] != 0).any()) and not bool((k[:, 6, :4] != 0).any())
    assert not bool((k[:, 7] != 0).any()) and cache.length.tolist() == [52]


def test_packed_kv_model_takes_a_uint8_pool(port):
    """The dense cache's dtype check holds for the pool: a ``packed_kv``
    model refuses a bf16 pool, a bf16 one a uint8 pool."""
    model = port["target"]
    table = torch.from_numpy(_table([[1]], 1))
    tokens = torch.tensor([[1]])
    with torch.no_grad():
        with pytest.raises(TypeError, match="uint8"):
            model.packed_kv = True
            try:
                model(tokens, PagedKVCache.zeros(T_SPEC, 1, 4, PAGE, MAX_PAGES)._replace(
                    page_table=table), FIXED)
            finally:
                model.packed_kv = False
        with pytest.raises(TypeError, match="bfloat16"):
            model(tokens, PagedKVCache.zeros(T_SPEC, 1, 4, PAGE, MAX_PAGES,
                                             dtype=torch.uint8)._replace(page_table=table),
                  FIXED)


def test_page_allocator():
    """JAX's ``test_page_allocator`` on both; the port's released pages go
    out again before untouched ones (JAX's after them)."""
    ours, theirs = PageAllocator(8), JAllocator(8)
    for a in (ours, theirs):
        assert a.num_free == 7
        got = a.alloc(3)
        assert got == [1, 2, 3] and a.num_free == 4 and a.alloc(0) == []
        a.release(got[1:] + [0])          # the trash page never returns to the pool
        assert a.num_free == 6
        with pytest.raises(RuntimeError, match="exhausted"):
            a.alloc(8)
    assert ours.alloc(3) == [2, 3, 4] and theirs.alloc(3) == [4, 5, 6]


# ---------------------------------------------------------------------------
# PagedBatcher against JAX's and against the dense batcher


def test_paged_batcher_tokens_equal_jax_and_dense(jax_side, jax_fixed):
    """FIXED: the port's plain paged batcher and its dense batcher over
    ``_schedule`` give JAX's paged tokens (greedy speculation emits the
    plain greedy tokens); every page comes back at retire."""
    model = torch_model(jax_side.calibrated, spec=J_SPEC)
    spec = LlamaSpec(**J_SPEC)
    b = _paged(model, spec)
    assert _schedule(b) == jax_fixed["tokens"]
    assert all(len(t) == NEW for t in jax_fixed["tokens"][:4])
    assert b.allocator.num_free == 23 and not b.table.any() and not b.lengths.any()
    assert _schedule(ContinuousBatcher(model, spec, slots=4)) == jax_fixed["tokens"]


def test_speculation_and_warm_self_draft_equal_jax(jax_side, jax_fixed):
    """The same schedule through the port's paged batcher with JAX's prefix
    cache settings and a self-draft: JAX's tokens and cache counts, and
    every proposal accepted, on the warm admissions too (the draft
    prefills the whole prompt)."""
    model = torch_model(jax_side.calibrated, spec=J_SPEC)
    pc = PrefixCache(max_tokens=256, bucket=8)
    b = _paged(model, LlamaSpec(**J_SPEC), prefix_cache=pc, draft_model=model,
               draft_spec=LlamaSpec(**J_SPEC), spec_k=K)
    assert _schedule(b) == jax_fixed["tokens"]
    print(f"self-draft acceptance over pages with warm admissions: JAX "
          f"{jax_fixed['acceptance']:.4f} ({jax_fixed['accepted']} of {jax_fixed['proposed']}), "
          f"the port {b.acceptance_rate:.4f} ({b.accepted} of {b.proposed})")
    assert (pc.misses, pc.hits) == (jax_fixed["misses"], jax_fixed["hits"]) == (5, 2)
    assert b.proposed > 0 and b.acceptance_rate == 1.0
    assert b.allocator.num_free == 23


def test_packed_kv_tokens_equal_jax_and_dense(jax_side):
    """PACKED with 1-byte weights and a uint8 pool: the port's paged and
    dense tokens equal JAX's paged tokens."""
    j = jax_side
    model = torch_model(j.cached, spec=J_SPEC)
    pack_llama(model)
    spec = LlamaSpec(**J_SPEC)
    jb = JPaged(j.packed_model, j.packed, j.spec, slots=4, num_pages=24, page_size=PAGE,
                qp=J_PACKED)
    want = _serve(jb)
    b = _paged(model, spec, qp=T_PACKED)
    assert b.cache.k_pages.dtype == torch.uint8
    assert _serve(b) == want and all(len(t) == NEW for t in want)
    assert _serve(ContinuousBatcher(model, spec, slots=4, qp=T_PACKED)) == want


def test_page_growth_and_reuse(port):
    """``tests/test_paged_kv.py::test_paged_batcher_page_growth_and_reuse``:
    pages are taken as a sequence crosses page edges and a retired slot's
    pages serve the next admissions; a pool too small for two dense slots
    serves two short prompts."""
    b = _paged(port["target"], slots=2, num_pages=8)
    slot = b.admit([1, 2, 3], max_new_tokens=PAGE * 2)
    assert b.allocator.num_free == 7 - 2 and b.pages_in_use == 2
    b.run_to_completion()
    assert int(b.lengths[slot]) == 3 + PAGE * 2 - 1
    assert np.count_nonzero(b.table[slot]) == 3
    b.retire(slot)
    assert b.allocator.num_free == 7
    s1, s2 = b.admit([5, 6], max_new_tokens=2), b.admit([7, 8, 9], max_new_tokens=2)
    b.run_to_completion()
    assert len(b.retire(s1)) == 2 and len(b.retire(s2)) == 2
    with pytest.raises(ValueError, match="max_seq"):
        b.admit(list(range(49)))


@pytest.mark.parametrize("qp", [FIXED, T_FAST_FUSED], ids=["fixed_einsum", "fast_fused"])
def test_warm_paged_admission_equals_cold(port, qp):
    """Warm paged admissions (the prefix scattered into fresh pages, the
    remainder over the gathered view: the einsum, or K7's plain version with
    offsets) give the cold paged run's tokens and the same logical rows."""
    model = port["target"]
    pc = PrefixCache(max_tokens=256, bucket=8)
    cold, warm = _paged(model, qp=qp), _paged(model, qp=qp, prefix_cache=pc)
    for p in HEADED:
        rows = []
        for b in (cold, warm):
            s = b.admit(p, max_new_tokens=6)
            rows.append(_gather_slot_slabs(b._cache(slice(s, s + 1))))
            b.run_to_completion()
            rows.append(b.retire(s))
        (ck, cv), c_out, (wk, wv), w_out = rows
        assert c_out == w_out
        assert torch.equal(ck[:, :, :len(p)], wk[:, :, :len(p)])
        assert torch.equal(cv[:, :, :len(p)], wv[:, :, :len(p)])
    assert (pc.misses, pc.hits) == (1, 2)


def test_prefix_entries_shared_with_the_dense_batcher(port):
    """An entry stored by the dense batcher serves a warm paged admission,
    and one stored by the paged batcher a warm dense one; each equals its
    cold run."""
    model = port["target"]
    first, second = HEADED[0], HEADED[1]
    cold = [_sequential(_paged(model), [p])[0] for p in (first, second)]
    pc = PrefixCache(max_tokens=256, bucket=8)
    assert _sequential(ContinuousBatcher(model, T_SPEC, slots=2, prefix_cache=pc),
                       [first]) == cold[:1]
    assert _sequential(_paged(model, prefix_cache=pc), [second]) == cold[1:]
    pc2 = PrefixCache(max_tokens=256, bucket=8)
    _sequential(_paged(model, prefix_cache=pc2), [first])
    assert _sequential(ContinuousBatcher(model, T_SPEC, slots=2, prefix_cache=pc2),
                       [second]) == cold[1:]
    assert (pc.hits, pc2.hits) == (1, 1)


# ---------------------------------------------------------------------------
# Speculation over pages, on the port alone


def _spec(port, **kw):
    return _paged(port["target"], draft_model=port["draft"], draft_spec=DRAFT_SPEC,
                  spec_k=K, **kw)


def test_spec_pages_released_and_kept_across_rollback(port):
    """A narrow draft (its proposals rejected): tokens equal the plain
    paged run's; each slot's pages only grow across rounds and always hold
    its length (a rollback keeps the pages of the whole k+1 round), and all
    come back at retire."""
    want = _serve(_paged(port["target"]), late=None)
    b = _spec(port)
    slots = [b.admit(p, max_new_tokens=NEW) for p in PROMPTS]
    owned = {s: [] for s in slots}
    while b.step():
        for s in slots:
            owned[s].append(int(np.count_nonzero(b.table[s])))
            assert owned[s][-1] * PAGE >= b.lengths[s] + 1
    assert [b.retire(s) for s in slots] == want
    assert all(o == sorted(o) for o in owned.values())
    assert 0 < b.proposed and b.accepted < b.proposed
    assert b.allocator.num_free == 23 and not b.table.any()


def test_spec_near_capacity_slot_finishes_early(port):
    """A slot within k+1 tokens of ``max_seq`` finishes instead of running a
    round past its table; its tokens are the plain paged run's."""
    prompt = np.random.default_rng(0).integers(0, SPEC["vocab_size"], 30).tolist()
    b = _spec(port, slots=1, num_pages=8)
    got = _sequential(b, [prompt], new=60)[0]
    s = SPEC["max_seq_len"]
    assert len(prompt) + len(got) + K + 1 > s and len(prompt) + len(got) <= s
    assert got == _sequential(_paged(port["target"], slots=1), [prompt], new=len(got))[0]


def test_stochastic_spec_paged_runs_rejects_and_repeats(port):
    params = sampling.SamplingParams(temperature=0.8, top_k=16)

    def run(seed):
        b = _spec(port, slots=2, sampling=params, seed=seed)
        return _serve(b, PROMPTS[:2], late=None, new=6), b

    (a, b1), (b, _), (c, _) = run(11), run(11), run(12)
    assert a == b and a != c and all(len(t) == 6 for t in a)
    assert 0 < b1.proposed and b1.accepted < b1.proposed


def test_mesh_is_a_later_slice(port):
    """The mesh-sharded paged batcher, once a later slice, is ported: over
    a (2, 2) mesh its tokens are the paged run's without a mesh; a mesh
    whose ``data`` axis does not divide the slots raises."""
    from fp8_quantization_tpu_torch.parallel import make_mesh

    cpus = [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="must divide over the data axis"):
        _paged(port["target"], mesh=make_mesh(data=3, devices=cpus))
    mesh = make_mesh(data=2, model=2, devices=cpus)
    assert _serve(_paged(port["target"], mesh=mesh)) == _serve(_paged(port["target"]))
