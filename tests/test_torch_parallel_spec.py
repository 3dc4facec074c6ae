"""The port's speculative batchers under a mesh on a virtual mesh of eight
CPU devices: ``tests/test_parallel.py``'s speculative continuous batcher
and its paged speculative batcher with a prefix cache, each over a (2, 4)
mesh, held to the port's run without a mesh and to JAX's single-device
tokens (token equality, the JAX test's rule). The draft is a model of
another init (key 1), so rejections and rollbacks occur.
"""

import numpy as np
import pytest
import torch
from test_torch_parallel_serving import _jax_parts, _port, _serve, mesh

from fp8_quantization_tpu.models.paged_kv import PagedBatcher as JPaged
from fp8_quantization_tpu.models.serving import ContinuousBatcher as JBatcher
from fp8_quantization_tpu_torch.models.paged_kv import PagedBatcher
from fp8_quantization_tpu_torch.models.prefix_cache import PrefixCache
from fp8_quantization_tpu_torch.models.serving import ContinuousBatcher

torch.set_num_threads(1)  # the suite's test workers share the machine's cores


@pytest.fixture(scope="module")
def parts():
    """(JAX target, JAX draft) parts, drawn as ``tests/test_parallel.py``
    draws them from its ``rng`` fixture."""
    rng = np.random.default_rng(10)
    return _jax_parts(rng, 0), _jax_parts(rng, 1)


def test_sharded_speculative_batcher_matches_single_device(parts):
    """The speculative batcher (a draft of another init) over a (2, 4) mesh
    emits the single-device tokens of the port and of JAX for every slot,
    with rejections."""
    (spec, jm, jv), (_, _, dv) = parts
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    jb = JBatcher(jm, jv, spec, slots=2, draft_model=jm, draft_variables=dv, draft_spec=spec,
                  spec_k=3)
    js = [jb.admit(p, max_new_tokens=7) for p in prompts]
    jb.run_to_completion()
    want = [[int(t) for t in jb.retire(s)] for s in js]
    tm, dm = _port(jv), _port(dv)

    def run(m):
        b = ContinuousBatcher(tm, tm.spec, slots=2, mesh=m, draft_model=dm,
                              draft_spec=dm.spec, spec_k=3)
        slots = [b.admit(p, max_new_tokens=7) for p in prompts]
        b.run_to_completion()
        assert b.accepted < b.proposed
        return [b.retire(s) for s in slots]

    assert run(mesh(2, 4)) == run(None) == want


def test_sharded_paged_speculative_prefix_matches_single_device(parts):
    """The paged batcher with a draft and a prefix cache over a (2, 4) mesh
    emits the cold single-device tokens of the port and of JAX, the cache
    hitting once."""
    (spec, jm, jv), (_, dmodel, dv) = parts
    shared = list(np.random.default_rng(12).integers(0, 64, size=20))
    prompts = [shared + [11, 12, 13], shared + [31, 32]]
    kw = dict(slots=2, num_pages=48, page_size=8, spec_k=3)
    want = _serve(JPaged(jm, jv, spec, draft_model=dmodel, draft_variables=dv,
                         draft_spec=spec, **kw), prompts, 6)
    tm, dm = _port(jv), _port(dv)
    cold = _serve(PagedBatcher(tm, tm.spec, draft_model=dm, draft_spec=dm.spec, **kw),
                  prompts, 6)
    pc = PrefixCache(max_tokens=256, bucket=16)
    warm = _serve(PagedBatcher(tm, tm.spec, mesh=mesh(2, 4), prefix_cache=pc, draft_model=dm,
                               draft_spec=dm.spec, **kw), prompts, 6)
    assert warm == cold == [[int(t) for t in o] for o in want]
    assert pc.misses == 1 and pc.hits == 1
