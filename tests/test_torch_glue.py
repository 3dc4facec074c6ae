"""The port's GLUE pipeline (``eval/glue.py``, a copy of the JAX package's
module) and its ``nlp`` entry point against the JAX package, on the CPU.

* WordPiece tokens and ids (punctuation, accents, CJK, control characters,
  long words), ``encode_pair``, ``load_examples`` on written TSVs (SST-2,
  MNLI, STS-B and CoLA without a header, malformed rows and unknown labels
  among them), ``glue_batches`` arrays, every metric and
  ``synthetic_task``: equal to the JAX package's.
* ``nlp.main(["--no-cuda", ...])`` at a tiny spec (monkeypatched, as the
  JAX package's ``tests/test_glue.py`` does) on the synthetic task, and on
  a written GLUE folder with a seeded ``--model-dir`` file.
* The int8 serving modes on the synthetic GLUE task, as the JAX package's
  ``tests/test_glue_serving.py`` holds them (hidden 32, 2 layers, 4 heads,
  MLP 64, batches of 8 x 32): from the JAX init (carried across with
  ``models.bridge``), the port's FAST, int8 PACKED and int8 CHAINED
  predictions equal JAX's, sample for sample, and PACKED and CHAINED agree
  with FAST on at least 95% of the samples, the JAX test's bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.eval import glue as jglue
from fp8_quantization_tpu.models.bert import BertSpec as JSpec
from fp8_quantization_tpu.models.bert import QuantizedBert as JBert
from fp8_quantization_tpu.ops.fastpath import pack_dense_caches as j_pack
from fp8_quantization_tpu.ops.fastpath import strip_packed_params as j_strip
from fp8_quantization_tpu.quant import sites as jsites
from fp8_quantization_tpu_torch import nlp
from fp8_quantization_tpu_torch.eval import glue as tglue
from fp8_quantization_tpu_torch.models import bert as tbert
from fp8_quantization_tpu_torch.models import porting
from fp8_quantization_tpu_torch.models.bridge import from_jax_variables
from fp8_quantization_tpu_torch.ops.cuda import KERNELS
from fp8_quantization_tpu_torch.quant import sites as tsites
from test_torch_bert import LOGIT_TOL, STATE_TOL, _jqc
from test_torch_vit import _numpy_tree

torch.set_num_threads(1)  # the suite's test workers share the machine's cores

VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "movie", "was", "great", "terrible", "un", "##believ", "##able",
    "##s", "##ly", "act", "##ing", ".", ",", "!", "?", "'", "a", "b", "c",
    "cafe", "naive", "中", "文", "##e", "e",
]
TEXTS = [
    "The movie was GREAT!",
    "unbelievable acting, terribly great?!",
    "Thé   movie\twas...great",
    "Café NAÏVE — crème brûlée",
    "中文 movie中文!",
    "a\x00b\x07c  the\r\nmovie",
    "zzz unbelievable' acting " + "x" * 120,
    "",
]


def _write(path, lines):
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def _launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


def test_tokenizer_matches_jax(tmp_path):
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    ours = tglue.WordPieceTokenizer.from_file(str(tmp_path / "vocab.txt"))
    theirs = jglue.WordPieceTokenizer.from_file(str(tmp_path / "vocab.txt"))
    for text in TEXTS:
        tokens = ours.tokenize(text)
        assert tokens == theirs.tokenize(text), text
        assert ours.convert_tokens_to_ids(tokens) == theirs.convert_tokens_to_ids(tokens)
    assert "[UNK]" in ours.tokenize(TEXTS[-2]) and "中" in ours.tokenize(TEXTS[4])
    for a, b in [(TEXTS[0], None), (TEXTS[1] * 6, TEXTS[3] * 6), (TEXTS[4], TEXTS[2])]:
        assert tglue.encode_pair(ours, a, b, 32) == jglue.encode_pair(theirs, a, b, 32)
    with pytest.raises(ValueError, match="special token"):
        tglue.WordPieceTokenizer(["[PAD]", "[CLS]"])


def _examples(mod, tmp_path, task):
    return [dataclasses.astuple(e) for e in mod.load_examples(
        str(tmp_path), mod.GLUE_TASKS[task], "dev")]


def test_load_examples_match_jax(tmp_path):
    """SST-2, MNLI (``dev_matched.tsv``), STS-B and CoLA (no header), with
    malformed rows and unknown labels skipped alike."""
    pad = ["x"] * 8
    cases = {
        "sst-2": ("dev.tsv", ["sentence\tlabel", "the movie was great\t1",
                              "terrible acting\t0", "malformed-row", "odd label\t7"]),
        "mnli": ("dev_matched.tsv", [
            "\t".join(["h"] * 12),
            "\t".join(pad + ["premise one", "hypothesis one", "x", "entailment"]),
            "\t".join(pad + ["premise two", "hypothesis two", "x", "contradiction"]),
            "\t".join(pad + ["premise three", "hypothesis", "x", "maybe"]),
            "short\trow"]),
        "sts-b": ("dev.tsv", ["\t".join(["h"] * 10),
                              "\t".join(["x"] * 7 + ["sent a", "sent b", "3.6"]),
                              "\t".join(["x"] * 7 + ["sent c", "sent d", "n/a"])]),
        "cola": ("dev.tsv", ["src\t1\t*\tthe movie was great", "src\t0\t\tterrible",
                             "src\t2\t\tbad label"]),
    }
    for task, (name, lines) in cases.items():
        folder = tmp_path / task
        folder.mkdir()
        _write(folder / name, lines)
        ours = _examples(tglue, folder, task)
        assert ours == _examples(jglue, folder, task), task
        assert ours, task
    assert len(_examples(tglue, tmp_path / "cola", "cola")) == 2
    assert tglue.GLUE_TASKS["sts-b"].num_labels == 1


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_synthetic_task_and_batches_match_jax(pair):
    """``synthetic_task`` and ``glue_batches`` (the last batch padded or
    not) give JAX's examples and arrays."""
    task, examples, tok = tglue.synthetic_task(num_examples=10, seed=3, pair=pair)
    j_task, j_examples, j_tok = jglue.synthetic_task(num_examples=10, seed=3, pair=pair)
    assert dataclasses.astuple(task) == dataclasses.astuple(j_task)
    assert [dataclasses.astuple(e) for e in examples] == [
        dataclasses.astuple(e) for e in j_examples]
    assert tok.inv_vocab == j_tok.inv_vocab
    for pad_final in (True, False):
        ours = list(tglue.glue_batches(examples, tok, 4, 16, pad_final=pad_final))
        theirs = list(jglue.glue_batches(j_examples, j_tok, 4, 16, pad_final=pad_final))
        assert len(ours) == len(theirs) == 3
        for (x, y, v), (jx, jy, jv) in zip(ours, theirs):
            for a, b in zip((*x, y, v), (*jx, jy, jv)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_metrics_match_jax():
    """Every metric on seeded predictions (ties included), and
    ``compute_glue_metrics`` for every task, equal to JAX's."""
    rng = np.random.default_rng(10)
    preds, labels = rng.integers(0, 2, 50), rng.integers(0, 2, 50)
    scores = np.round(rng.normal(size=50), 1)
    targets = scores + np.round(rng.normal(size=50), 1)
    for name in ("accuracy_score", "f1_score", "matthews_corrcoef"):
        assert getattr(tglue, name)(preds, labels) == getattr(jglue, name)(preds, labels)
    for name in ("pearson_corr", "spearman_corr"):
        assert getattr(tglue, name)(scores, targets) == getattr(jglue, name)(scores, targets)
    assert tglue.f1_score(np.zeros(4), np.zeros(4)) == 0.0
    for name, task in tglue.GLUE_TASKS.items():
        p, y = (scores, targets) if task.labels is None else (preds, labels)
        assert tglue.compute_glue_metrics(task, p, y) == jglue.compute_glue_metrics(
            jglue.GLUE_TASKS[name], p, y), name


@pytest.fixture
def tiny_bert(monkeypatch):
    """``nlp`` builds ``bert.BERT_BASE`` with the task's classes: a tiny one."""
    tiny = dataclasses.replace(tbert.BERT_BASE, vocab_size=64, hidden_size=32, num_layers=2,
                               num_heads=4, mlp_dim=64, max_position_embeddings=64)
    monkeypatch.setattr(tbert, "BERT_BASE", tiny)
    return tiny


def _main_capturing(argv):
    """``nlp.main(argv)``'s metrics and the model it built (the first
    argument of its forwards)."""
    models = []
    forward = nlp.forward
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nlp, "forward", lambda model, *a, **kw: models.append(model)
                   or forward(model, *a, **kw))
        metrics = nlp.main(argv)
    assert all(m is models[0] for m in models)
    return metrics, models[0]


def test_nlp_main_synthetic(tiny_bert, capsys):
    argv = ["--no-cuda", "--batch-size", "4", "--seq-len", "24", "--max-eval-batches", "3"]
    before = _launches()
    metrics = nlp.main(argv + ["--num-est-batches", "1"])
    assert _launches() == before                       # CPU tensors: plain versions
    assert set(metrics) == {"accuracy", "f1"}
    assert 0.0 <= metrics["accuracy"] <= 1.0
    again, model = _main_capturing(argv)
    assert again == metrics                            # seeded: the same run again
    out = capsys.readouterr().out
    assert "task: synthetic (12 examples)" in out and f"final_metrics: {metrics}" in out
    assert next(model.parameters()).device.type == "cpu"
    sites = [m for m in model.modules() if isinstance(m, tsites.QuantSite)]
    assert all(torch.isfinite(m.maxval).all() and (m.maxval > 0).all() for m in sites)


def test_nlp_main_glue_dir_and_model_dir(tiny_bert, tmp_path, monkeypatch, capsys):
    """A written SST-2 folder and ``vocab.txt``, and a seeded HF-named state
    dict through ``--model-dir``: every tensor read, every ported parameter
    equal to the file's after its layout change."""
    _write(tmp_path / "dev.tsv", ["sentence\tlabel", "the movie was great\t1",
                                  "terrible acting\t0", "the movie was terrible\t0",
                                  "great great great\t1", "acting was great\t1"])
    _write(tmp_path / "train.tsv", ["sentence\tlabel", "the movie was great\t1", "terrible\t0"])
    _write(tmp_path / "vocab.txt", VOCAB)
    spec = dataclasses.replace(tiny_bert, vocab_size=len(VOCAB) + 8)
    state = porting.seeded_source_state("bert_quantized", torch.Generator().manual_seed(1),
                                        spec=spec)
    torch.save(state, tmp_path / "bert.bin")
    monkeypatch.setattr(tbert, "BERT_BASE", spec)
    argv = ["--no-cuda", "--data-dir", str(tmp_path), "--task", "sst-2", "--batch-size", "2",
            "--seq-len", "16"]
    metrics, model = _main_capturing(argv + ["--model-dir", str(tmp_path / "bert.bin")])
    assert set(metrics) == {"accuracy"}
    assert "task: sst-2 (5 examples)" in capsys.readouterr().out
    used = porting.UsedKeys(state)
    ported = porting.port_architecture("bert_quantized", used, model)
    assert porting.unported_keys(used) == ()
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in ported.items())
    _, seeded = _main_capturing(argv)
    assert not torch.equal(seeded.pooler.kernel, model.pooler.kernel)


def test_int8_serving_predictions_match_jax():
    """``tests/test_glue_serving.py``'s flow on both sides: the synthetic
    task (48 examples, batches of 8 x 32), init on the first row, one
    calibration batch, the weights cached, packed and stripped
    (``scripts/bench_bert.py``'s int8 setup); the int8 codes and column
    sums bit for bit, their scales within ``STATE_TOL``; FAST, int8 PACKED
    and int8 CHAINED logits within ``LOGIT_TOL`` (``tests/
    test_torch_bert.py``'s tolerances) and the same predictions."""
    task, examples, tok = tglue.synthetic_task(num_examples=48)
    spec = dict(vocab_size=len(tok.vocab), hidden_size=32, num_layers=2, num_heads=4,
                mlp_dim=64, max_position_embeddings=32, num_classes=task.num_labels)
    batches = list(tglue.glue_batches(examples, tok, batch_size=8, max_len=32))
    (ids0, mask0, types0), _, _ = batches[0]
    jm = JBert(qc=_jqc(nlp.int8_serving_qc()), spec=JSpec(**spec))
    init = jax.jit(lambda k, i, m, t: jm.init(k, i, m, t, jsites.ESTIMATE))(
        jax.random.key(0, impl="rbg"), jnp.asarray(ids0[:1]), jnp.asarray(mask0[:1]),
        jnp.asarray(types0[:1]))
    init = _numpy_tree(init)

    def prepare(v):
        _, ups = jm.apply(v, ids0, mask0, types0, jsites.ESTIMATE,
                          mutable=["quant", "quant_est"])
        v = {**v, **ups}
        warm = jsites.QuantPhase(phase="fixed", fast=True, cache_weights=True)
        _, ups = jm.apply(v, ids0, mask0, types0, warm, mutable=["quant_cache"])
        return {**v, **ups}

    cached = jax.jit(prepare)(init)
    packed, report = j_pack(cached, jm.qc)
    assert report
    packed = j_strip(packed)
    phases = {"fast": jsites.FAST, "int8 packed": jsites.PACKED,
              "int8 chained": jsites.CHAINED}
    serve = jax.jit(lambda c, p, i, m, t: {
        name: jm.apply(c if name == "fast" else p, i, m, t, qp).astype(jnp.float32)
        for name, qp in phases.items()})
    j_logits = {name: [] for name in phases}
    for (ids, mask, types), _, _ in batches:
        for name, logits in serve(cached, packed, ids, mask, types).items():
            j_logits[name].append(np.asarray(logits))

    tm = tbert.QuantizedBert(nlp.int8_serving_qc(), tbert.BertSpec(**spec))
    tm.load_state_dict(from_jax_variables(init), strict=True)
    nlp.forward(tm, ids0, mask0, types0, tsites.ESTIMATE)
    before = _launches()
    logits = {}
    for mode, qp in nlp.int8_modes(tm, nlp.int8_serving_qc(), ids0, mask0):
        logits[mode.replace("int8 fast", "fast")] = [
            nlp.forward(tm, ids, mask, types, qp).float().numpy() for (ids, mask, types), _, _
            in batches]
    assert _launches() == before
    assert tm.classifier.kernel is None and tm.classifier.w_i8.dtype == torch.int8
    got = tm.state_dict()
    codes = {k: v for k, v in from_jax_variables(
        _numpy_tree({"quant_cache": packed["quant_cache"]})).items() if ".w_i8" in k}
    assert sum(k.endswith(".w_i8") for k in codes) == 6 * spec["num_layers"] + 2
    for key, value in codes.items():
        if key.endswith((".w_i8", ".w_i8_sum")):
            np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)
        else:
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), err_msg=key,
                                       **STATE_TOL)
    valid = np.concatenate([v for _, _, v in batches]) > 0
    preds = {}
    for name in phases:
        ours, theirs = np.concatenate(logits[name]), np.concatenate(j_logits[name])
        assert np.isfinite(ours).all(), name
        np.testing.assert_allclose(ours, theirs, err_msg=name, **LOGIT_TOL)
        preds[name] = ours.argmax(-1)[valid]
        np.testing.assert_array_equal(preds[name], theirs.argmax(-1)[valid], err_msg=name)
    fast = preds["fast"]
    for mode in ("int8 packed", "int8 chained"):
        assert (preds[mode] == fast).mean() >= 0.95, mode
    labels = np.asarray([ex.label for ex in examples])
    metrics = tglue.compute_glue_metrics(task, fast, labels[:len(fast)])
    assert 0.0 <= metrics["accuracy"] <= 1.0
