"""The port's quantized BERT against the JAX package's, at a tiny size:
hidden 32, 4 heads, MLP 64, one layer, vocab 120, 3 classes, batches of 4
x 16 tokens with token types and a ragged mask (row 1 keeps 2 of its 16
tokens, row 3 eleven). One layer because tracing and compiling the JAX
programs takes most of this file's time (each layer adds ~40%); the
port-only checks run two, and ``tests/test_torch_glue.py`` holds a
two-layer model's int8 serving modes (FAST, PACKED, CHAINED: codes and
logits, at this file's tolerances) to JAX's on the GLUE task.

The JAX model's init (its ``ESTIMATE`` forward on the first batch) is
carried into the port with ``models.bridge.from_jax_variables``; HF
``BertForSequenceClassification`` weights (a seeded state dict under HF's
names, ``porting.seeded_source_state``) are then ported into both, as the
``nlp`` entry points do, and both calibrate on a second batch and evaluate
a third.

E5M2 runs through the E4M3 model's compiled JAX programs: the JAX
quantizers read their width from the site state (``quant/.../q/
mantissa_bits``), so those programs on a state whose width is 2 compute
the E5M2 model. Its init forward runs from flax's fresh state (every range
empty, the E4M3 init's parameters, which the HF weights replace) through
the ``run`` program instead of a second flax ``init``. Checked against the
E5M2 model's own ``init`` and ``run`` programs at ``SEED``: FIXED logits
bit-equal, the calibrated state equal but one LayerNorm site's ``xmax``,
an ulp apart (XLA fuses the LayerNorm otherwise in the two programs).

Tolerances:

* ``port_bert``: equal to the JAX tree, every tensor of the file read;
* ``FP32`` logits (quantization off): ``rtol=atol=1e-5`` at every seed
  tried (0..3);
* calibrated site state: ``rtol=atol=1e-6``; ``FIXED`` (E4M3 and E5M2),
  ``FAST`` and FP8 ``PACKED`` logits: ``rtol=atol=1e-5`` and the same
  top-1; the packed FP8 codes bit for bit.
  Sums run in another order in the two frameworks, and XLA's CPU
  ``rsqrt``, ``exp``, ``erf`` and ``tanh`` are not correctly rounded, so a
  LayerNorm, softmax, GELU or pooler value within those ulps of a rounding
  midpoint would land one grid step apart. No seed of 0..7 fails: each
  holds every quantized mode above, and the int8 FAST, PACKED and CHAINED
  logits of this model, at these tolerances (checked once; the file runs
  ``SEED`` alone, the ViT's seed 2, for its clock).
* The mask's bias dtype, int32 and int64 ids, ``--cuda`` without a GPU.

On the CPU every kernel wrapper takes its plain version: the launch counters
must not move. The JAX side runs its packed FP8 product through its Pallas
kernel in interpret mode, as its own tests do.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.models import porting as jporting
from fp8_quantization_tpu.models.bert import BertSpec as JSpec
from fp8_quantization_tpu.models.bert import QuantizedBert as JBert
from fp8_quantization_tpu.ops.pallas import dequant_matmul as j_dm
from fp8_quantization_tpu.ops.fastpath import pack_dense_caches as j_pack
from fp8_quantization_tpu.quant.quantizers import default_maxval
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import nlp
from fp8_quantization_tpu_torch.models import bert as tbert
from fp8_quantization_tpu_torch.models import porting
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.ops.cuda import KERNELS
from fp8_quantization_tpu_torch.quant import sites as tsites
from test_torch_vit import _numpy_tree

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

SEED = 2
TINY = dict(vocab_size=120, hidden_size=32, num_layers=1, num_heads=4, mlp_dim=64,
            max_position_embeddings=32, num_classes=3)
BATCH, SEQ = 4, 16
STATE_TOL = dict(rtol=1e-6, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
J_PHASE = {"fp32": jsites.FP32, "fixed": jsites.FIXED, "fast": jsites.FAST,
           "fp8 packed": jsites.PACKED}
FP8_MODES = ("fp32", "fixed", "fast")   # the FP8 ``run`` program's modes


def _launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


def _jqc(tqc):
    """The JAX package's ``QuantConfig`` with the port's fields."""
    from fp8_quantization_tpu import config as jc

    return jc.QuantConfig(
        method=jc.QMethod(tqc.method.value), per_channel_weights=tqc.per_channel_weights,
        quantize_input=tqc.quantize_input, n_bits=tqc.n_bits,
        weight_range=jc.EstimatorConfig(jc.RangeMethod(tqc.weight_range.method.value)),
        act_range=jc.EstimatorConfig(jc.RangeMethod(tqc.act_range.method.value)),
        fp8=jc.FP8Config(**dataclasses.asdict(tqc.fp8)),
        run_method=jc.RunMethodConfig(**dataclasses.asdict(tqc.run_method)))


def _inputs(seed=SEED):
    """Three batches (init, calibration, eval) of (ids, mask, token types)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        ids = rng.integers(0, TINY["vocab_size"], size=(BATCH, SEQ)).astype(np.int32)
        mask = np.ones((BATCH, SEQ), np.int32)
        mask[1, 2:] = 0
        mask[3, 11:] = 0
        types = np.zeros((BATCH, SEQ), np.int32)
        types[:, SEQ // 2:] = 1
        out.append((ids, mask, types))
    return out


def _j(batch):
    return [None if a is None else jnp.asarray(a) for a in batch]


def _hf_state(seed=SEED):
    return porting.seeded_source_state("bert_quantized", torch.Generator().manual_seed(seed),
                                       spec=tbert.BertSpec(**TINY))


def _hf_params(seed=SEED):
    params, _ = jporting.port_bert(jporting.torch_state_to_numpy(_hf_state(seed)),
                                   num_layers=TINY["num_layers"])
    return params


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_packing():
    """Has the JAX package's ``pack_dense_caches`` call its ``pack_weights``
    jitted (the function unchanged, its codes bit for bit the same): op by
    op it takes ~1.5 s a layer on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_dm, "pack_weights", jax.jit(j_dm.pack_weights, static_argnums=(2, 3)))
        yield


class _JaxSide:
    """The JAX model of one configuration and its jitted programs, each
    compiled once for the file's batch shape: ``init`` (flax's, an ESTIMATE
    forward), ``run``, which from given variables calibrates on one batch
    (ESTIMATE), caches the weights in bf16 when ``modes`` has FAST, and
    returns the variables with the logits of another batch in each phase of
    ``modes``, and ``serve`` (logits only). Few, larger programs: tracing
    and compiling take most of this file's time."""

    def __init__(self, tqc):
        jm = self.jm = JBert(qc=_jqc(tqc), spec=JSpec(**TINY))
        self.init = jax.jit(lambda key, i, m, t: jm.init(key, i, m, t, jsites.ESTIMATE))

        def run(v, calib, batch, modes):
            _, ups = jm.apply(v, *calib, jsites.ESTIMATE, mutable=["quant", "quant_est"])
            v = {**v, **ups}
            if "fast" in modes:
                warm = jsites.QuantPhase(phase="fixed", fast=True, cache_weights=True)
                _, ups = jm.apply(v, *calib, warm, mutable=["quant_cache"])
                v = {**v, **ups}
            return v, {m: jm.apply(v, *batch, J_PHASE[m]).astype(jnp.float32) for m in modes}

        self.run = jax.jit(run, static_argnums=3)
        self.serve = jax.jit(lambda v, batch, modes: {
            m: jm.apply(v, *batch, J_PHASE[m]).astype(jnp.float32) for m in modes},
            static_argnums=2)


def _program_qc(tqc):
    """The configuration whose JAX programs run ``tqc``: an FP8 one at
    E4M3, the width being site state (the module's docstring)."""
    if tqc.method.value != "fp_quantizer":
        return tqc
    return dataclasses.replace(tqc, fp8=dataclasses.replace(tqc.fp8, mantissa_bits=3))


def _side(tqc):
    return _sides(_program_qc(tqc))


@functools.lru_cache(maxsize=None)
def _sides(program_qc):
    return _JaxSide(program_qc)


def _fresh(variables, n_bits, mantissa_bits):
    """``variables``' state as flax creates it before the init forward, at
    ``mantissa_bits``: every allminmax range empty, every FP8 site at that
    width and its default maxval (``estimators.init``,
    ``quantizers.fp_init``); the parameters as they are."""
    fresh = {"xmin": np.inf, "xmax": -np.inf, "count": 0, "mantissa_bits": mantissa_bits,
             "maxval": default_maxval(n_bits, mantissa_bits)}

    def reset(path, x):
        name = path[-1].key
        return np.full_like(x, fresh[name]) if name in fresh else x

    return {k: v if k == "params" else jax.tree_util.tree_map_with_path(reset, v)
            for k, v in variables.items()}


@functools.lru_cache(maxsize=None)
def _jax_init(tqc, seed=SEED):
    """flax ``init`` (an ESTIMATE forward) on the first batch, as numpy; at
    another FP8 width than E4M3, the same forward from the E4M3 init's
    fresh state through the ``run`` program."""
    base = _program_qc(tqc)
    inputs = [_j(b) for b in _inputs(seed)]
    if base != tqc:
        init = _jax_init(base, seed)
        out, _ = _side(tqc).run(_fresh(init, tqc.n_bits, tqc.fp8.mantissa_bits),
                                inputs[0], inputs[2], FP8_MODES)
        return _numpy_tree({k: out[k] for k in init})
    # the RBG generator's init compiles in less time than threefry's
    key = jax.random.key(seed, impl="rbg")
    return _numpy_tree(_side(tqc).init(key, *inputs[0]))


@functools.lru_cache(maxsize=None)
def _jax_run(tqc, seed=SEED, modes=FP8_MODES):
    """The ``nlp`` sequence in JAX: init on the first batch, the HF weights
    laid over it, one calibration batch, the weights cached in bf16 when
    ``modes`` has FAST, then the third batch's logits in ``modes``.
    Returns (init, calibrated (and cached) variables, {mode: logits})."""
    init = _jax_init(tqc, seed)
    v = jporting.merge_ported(init, _hf_params(seed), {})
    inputs = _inputs(seed)
    out, logits = _side(tqc).run(v, _j(inputs[1]), _j(inputs[2]), modes)
    return init, _numpy_tree(out), {k: np.asarray(x) for k, x in logits.items()}


def _port_from(tqc, variables):
    tm = tbert.QuantizedBert(tqc, tbert.BertSpec(**TINY))
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    return tm


def _with_hf_weights(tm, seed=SEED):
    tm.load_state_dict(porting.merge_ported(
        tm.state_dict(), porting.port_bert(_hf_state(seed), TINY["num_layers"])))
    return tm


def test_port_bert_matches_jax():
    """``port_bert`` on an HF-named file equals the JAX package's ported
    tree after the bridge, reads every tensor, and fills every parameter of
    the model."""
    state = _hf_state()
    used = porting.UsedKeys(state)
    model = tbert.QuantizedBert(nlp.nlp_qc(), tbert.BertSpec(**TINY))
    ours = porting.port_architecture("bert_quantized", used, model)
    theirs = from_jax_variables({"params": _numpy_tree(_hf_params())})
    assert ours.keys() == theirs.keys()
    for key, value in theirs.items():
        assert ours[key].dtype == torch.float32
        assert torch.equal(ours[key], value), key
    assert porting.unported_keys(used) == ()
    assert set(ours) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fp32_logits_match_jax(seed):
    """Quantization off: the ported HF weights over each side's init give
    the same logits within 1e-5 at every seed."""
    tqc = nlp.nlp_qc(8, 3)
    init, _, j_logits = _jax_run(tqc, seed)
    tm = _with_hf_weights(_port_from(tqc, init), seed)
    before = _launches()
    t_logits = nlp.forward(tm, *_inputs(seed)[2], qp=tsites.FP32).numpy()
    assert _launches() == before
    assert t_logits.shape == (BATCH, TINY["num_classes"])
    np.testing.assert_allclose(t_logits, j_logits["fp32"], **LOGIT_TOL)


def _port_calibrated(tqc, init):
    tm = _with_hf_weights(_port_from(tqc, init))
    nlp.forward(tm, *_inputs()[1], qp=tsites.ESTIMATE)
    return tm


@pytest.mark.parametrize("mantissa_bits", [3, 2], ids=["E4M3", "E5M2"])
def test_calibrated_fixed_matches_jax(mantissa_bits):
    """The port's ``nlp`` sequence from JAX's init: the ported weights laid
    over it (its act ranges keep what the init forward saw), one
    calibration batch, then FIXED: site state and logits within this
    file's tolerances."""
    tqc = nlp.nlp_qc(8, mantissa_bits)
    init, calibrated, j_logits = _jax_run(tqc)
    before = _launches()
    tm = _port_calibrated(tqc, init)
    t_fixed = nlp.forward(tm, *_inputs()[2], qp=tsites.FIXED).numpy()
    assert _launches() == before
    expect = from_jax_variables({k: calibrated[k] for k in ("quant", "quant_est")})
    got = tm.state_dict()
    assert len(expect) > 60
    for key, value in expect.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), err_msg=key, **STATE_TOL)
    assert np.isfinite(t_fixed).all()
    np.testing.assert_allclose(t_fixed, j_logits["fixed"], **LOGIT_TOL)
    np.testing.assert_array_equal(t_fixed.argmax(-1), j_logits["fixed"].argmax(-1))


def test_init_forward_widens_act_ranges():
    """The reference behaviour the port keeps: the init forward with the
    seeded weights seeds the allminmax act ranges, and calibrating the
    ported weights keeps their union, so some act sites end wider than a
    fresh model's calibrated on the ported weights alone (ROADMAP §3)."""
    _, calibrated, _ = _jax_run(nlp.nlp_qc(8, 3))
    fresh = _with_hf_weights(tbert.QuantizedBert(nlp.nlp_qc(8, 3), tbert.BertSpec(**TINY)))
    nlp.forward(fresh, *_inputs()[1], qp=tsites.ESTIMATE)
    kept = from_jax_variables({"quant_est": calibrated["quant_est"]})
    got = fresh.state_dict()
    act = [k[:-len(".xmin")] for k in kept
           if k.endswith(".xmin") and "weight_quantizer" not in k]
    wider = [k for k in act if float(kept[k + ".xmin"].min()) < float(got[k + ".xmin"].min())
             or float(kept[k + ".xmax"].max()) > float(got[k + ".xmax"].max())]
    print(f"{len(wider)} of {len(act)} act sites widened by the init forward")
    assert 0 < len(wider) <= len(act)


def test_fp8_serving_modes_match_jax():
    """The port's FP8 serving modes, prepared by ``nlp.fp8_modes`` from the
    E4M3 ``nlp`` calibration, against JAX's from the same calibration (as
    ``scripts/bench_bert.py`` sets them up: FAST on the bf16 weight cache,
    PACKED on its codes): the packed codes bit for bit, fp32, fixed, fast
    and packed logits within ``LOGIT_TOL`` with the same top-1."""
    tqc = nlp.nlp_qc(8, 3)
    init, cached, j_logits = _jax_run(tqc)
    side = _side(tqc)
    packed, report = j_pack(cached, side.jm.qc)
    assert report
    batch = _inputs()[2]
    j_logits = {**j_logits, **{k: np.asarray(v) for k, v in side.serve(
        packed, _j(batch), ("fp8 packed",)).items()}}
    before = _launches()
    tm = _port_calibrated(tqc, init)
    ours = {mode: nlp.forward(tm, *batch, qp=qp).float().numpy()
            for mode, qp in nlp.fp8_modes(tm, tqc, *_inputs()[1][:2])}
    assert _launches() == before
    assert set(ours) == set(j_logits)
    got = tm.state_dict()
    codes = {k: v for k, v in from_jax_variables(
        _numpy_tree({"quant_cache": packed["quant_cache"]})).items()
        if k.endswith((".w_codes", ".w_pack_bias"))}
    assert len(codes) == 2 * (6 * TINY["num_layers"] + 2)
    for key, value in codes.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)
    for mode, logits in j_logits.items():
        assert np.isfinite(ours[mode]).all(), mode
        np.testing.assert_allclose(ours[mode], logits, err_msg=mode, **LOGIT_TOL)
        np.testing.assert_array_equal(ours[mode].argmax(-1), logits.argmax(-1))


def test_mask_bias_follows_the_block_input_dtype(monkeypatch):
    """The mask's bias takes the block input's dtype, as in the JAX model:
    bf16 where the input arrives bf16 (-1e9 on the bf16 grid), f32
    otherwise. Without ``quantize_input`` the LayerNorms' output sites hand
    bf16 on under FAST, so every block's bias is bf16 there; a row that
    keeps 2 of its 16 tokens gives the same logits, bit for bit, whatever
    ids its 14 padded positions hold. (That path's GELU runs on bf16 values,
    which XLA's fused CPU code rounds otherwise than PyTorch: its logits
    are not compared with JAX's.)"""
    x = torch.zeros(2, 3, dtype=torch.bfloat16)
    mask = torch.tensor([[1, 1, 0], [1, 0, 0]], dtype=torch.int32)
    bias = tbert.mask_bias(mask, x)
    j_bias = (1.0 - jnp.asarray(mask.numpy())[:, None, None, :].astype(jnp.bfloat16)) * -1e9
    assert bias.dtype == torch.bfloat16 and j_bias.dtype == jnp.bfloat16
    np.testing.assert_array_equal(bias.float().numpy(), np.asarray(j_bias).astype(np.float32))
    assert tbert.mask_bias(mask, torch.zeros(2, 3)).dtype == torch.float32

    dtypes = []
    bias_fn = tbert.mask_bias
    monkeypatch.setattr(tbert, "mask_bias",
                        lambda m, x: dtypes.append(x.dtype) or bias_fn(m, x))
    tqc = dataclasses.replace(nlp.fp8_serving_qc(), quantize_input=False)
    tm = tbert.QuantizedBert(tqc, tbert.BertSpec(**dict(TINY, num_layers=2)),
                             generator=torch.Generator().manual_seed(0))
    calib, (ids, mask, types) = _inputs()[1], _inputs()[2]
    nlp.forward(tm, *calib, qp=tsites.ESTIMATE)
    dtypes.clear()
    fast = nlp.forward(tm, ids, mask, types, tsites.FAST)
    assert dtypes == [torch.bfloat16] * 2
    other = ids.copy()
    other[1, 2:] = (other[1, 2:] + 7) % TINY["vocab_size"]
    again = nlp.forward(tm, other, mask, types, tsites.FAST)
    assert torch.equal(fast[1], again[1]) and not torch.equal(fast[0], fast[1])
    assert torch.isfinite(fast.float()).all()


def test_ids_and_token_types():
    """int32 and int64 ids index alike, and no token types means zeros."""
    tm = tbert.QuantizedBert(nlp.nlp_qc(), tbert.BertSpec(**TINY),
                             generator=torch.Generator().manual_seed(0))
    ids, mask, _ = _inputs()[0]
    a = nlp.forward(tm, ids, mask, None, tsites.FP32)
    b = nlp.forward(tm, ids.astype(np.int64), mask, np.zeros_like(ids), tsites.FP32)
    assert torch.equal(a, b)


def test_cuda_without_gpu_raises(monkeypatch):
    """``--cuda`` (the default) never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert nlp.build_parser().parse_args([]).cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nlp.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nlp.main(["--cuda", "--max-eval-batches", "1"])
