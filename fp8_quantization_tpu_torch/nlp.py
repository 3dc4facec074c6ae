"""GLUE / BERT quantized evaluation, port of the root ``nlp.py``:

    python -m fp8_quantization_tpu_torch.nlp [--data-dir DIR --task sst-2]
        [--model-dir bert.bin] [--no-cuda] ...

Runs BERT-base sequence classification through calibrate -> fix ->
evaluate on a GLUE task: TSV data and WordPiece tokens from ``--data-dir``
and ``--vocab-file`` (``eval.glue``), or the deterministic synthetic task
when no dataset is given. The same flags and defaults as the JAX package's
script, and ``--cuda`` (the default: the GPU, raising where there is none)
or ``--no-cuda``. The sequence is the JAX script's: the model is built with
seeded weights and its init ``ESTIMATE`` forward runs on the first
calibration batch, then the ``--model-dir`` weights (an HF
``BertForSequenceClassification`` state dict) are laid over it, so the
allminmax act ranges keep what that forward saw, as the JAX ranges do.

The module also sets up BERT's serving modes as the JAX package's
``scripts/bench_bert.py`` does (:func:`fp8_modes`, :func:`int8_modes`):
fp32, fixed, fast and FP8 packed under its FP8 configuration, int8 packed
and int8 chained under the reference-default run method (with that
configuration's FAST before them, the reference of the JAX package's GLUE
serving test).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from .config import (
    EstimatorConfig,
    FP8Config,
    QMethod,
    QuantConfig,
    RangeMethod,
    RunMethodConfig,
)
from .quant.sites import CHAINED, ESTIMATE, FAST, FIXED, FP32, PACKED, QuantPhase


def build_parser() -> argparse.ArgumentParser:
    from .cli import _add_bool_flag

    p = argparse.ArgumentParser(prog="python -m fp8_quantization_tpu_torch.nlp")
    p.add_argument("--model-dir", type=str, default=None,
                   help="HF BertForSequenceClassification torch state dict "
                        "(.bin/.pth/.pt), or a checkpoint of the port's own")
    p.add_argument("--data-dir", type=str, default=None,
                   help="GLUE task dir containing train.tsv/dev.tsv")
    p.add_argument("--task", type=str, default="sst-2",
                   help="cola|sst-2|mrpc|sts-b|qqp|mnli|mnli-mm|qnli|rte|wnli")
    p.add_argument("--vocab-file", type=str, default=None,
                   help="BERT vocab.txt (defaults to <data-dir>/vocab.txt)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--num-est-batches", type=int, default=1)
    p.add_argument("--max-eval-batches", type=int, default=None)
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--n-bits", type=int, default=8)
    p.add_argument("--fp8-mantissa-bits", type=int, default=2,
                   help="2 -> E5M2 activations (BASELINE config[3])")
    _add_bool_flag(p, "cuda", True, help="run on the GPU (raises if there is none)")
    return p


def nlp_qc(n_bits: int = 8, mantissa_bits: int = 2) -> QuantConfig:
    """The script's configuration: FP8 per-channel weights (current
    min/max), allminmax acts, quantize-input, res-quantizer and original
    quantize-res; ``mantissa_bits`` 2 is E5M2."""
    return QuantConfig(
        method=QMethod.fp_quantizer, per_channel_weights=True, quantize_input=True,
        n_bits=n_bits,
        weight_range=EstimatorConfig(RangeMethod.current_minmax),
        act_range=EstimatorConfig(RangeMethod.allminmax),
        fp8=FP8Config(set_maxval=True, mantissa_bits=mantissa_bits,
                      mse_include_mantissa_bits=False),
        run_method=RunMethodConfig(res_quantizer_flag=True, original_quantize_res=True))


def fp8_serving_qc() -> QuantConfig:
    """``scripts/bench_bert.py``'s FP8 family: :func:`nlp_qc` at E3M4."""
    return nlp_qc(8, 4)


def int8_serving_qc() -> QuantConfig:
    """``scripts/bench_bert.py``'s int8 family: symmetric uniform, the
    reference-default run method (no res site: plain PTQ)."""
    return QuantConfig(
        method=QMethod.symmetric_uniform, per_channel_weights=True, quantize_input=True,
        weight_range=EstimatorConfig(RangeMethod.current_minmax),
        act_range=EstimatorConfig(RangeMethod.allminmax),
        run_method=RunMethodConfig())


def _tensors(device, *arrays):
    return [None if a is None else torch.as_tensor(np.asarray(a)).to(device)
            for a in arrays]


@torch.no_grad()
def forward(model, ids, mask=None, types=None, qp: QuantPhase = FIXED):
    """``model`` on numpy or torch ids, mask and token types, moved to its
    device."""
    dev = next(model.parameters()).device
    return model(*_tensors(dev, ids, mask, types), qp=qp)


@torch.no_grad()
def cache_weights(model, ids, mask=None, types=None, *, fast: bool):
    """The ``cache_weights`` forward: each layer stores its frozen
    quantized weights (bf16 under ``fast``)."""
    forward(model, ids, mask, types, QuantPhase(phase="fixed", fast=fast, cache_weights=True))


def ragged_batch(spec, batch: int = 32, seq_len: int = 128, seed: int = 10):
    """``scripts/bench_bert.py``'s input: seeded ids over the vocab and a
    mask whose second half of sequences ends at 60% of ``seq_len``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, spec.vocab_size, size=(batch, seq_len)).astype(np.int32)
    mask = np.ones((batch, seq_len), np.int32)
    mask[batch // 2:, int(seq_len * 0.6):] = 0
    return ids, mask


def serving_model(qc, spec, ids, mask, device, generator):
    """``scripts/bench_bert.py``'s ``setup``: the model built from
    ``generator``, its init ``ESTIMATE`` forward on the first row, then one
    calibration forward on the first two rows."""
    from .models.bert import QuantizedBert

    model = QuantizedBert(qc, spec, generator=generator).to(device)
    forward(model, ids[:1], mask[:1], None, ESTIMATE)
    forward(model, ids[:2], mask[:2], None, ESTIMATE)
    return model


def fp8_modes(model, qc, ids, mask):
    """Yield ``(mode, phase)`` for the FP8 family of :func:`serving_model`'s
    ``model``, preparing it in place between modes: fp32 and fixed on the
    f32 weights, fast after the bf16 ``cache_weights`` forward (on the
    calibration rows), FP8 packed after ``pack_dense_caches`` and
    ``strip_packed_params`` (the f32 kernels are dropped: run the modes in
    order)."""
    from .ops.fastpath import pack_dense_caches, strip_packed_params

    yield "fp32", FP32
    yield "fixed", FIXED
    cache_weights(model, ids[:2], mask[:2], fast=True)
    yield "fast", FAST
    pack_dense_caches(model, qc)
    strip_packed_params(model)
    yield "fp8 packed", PACKED


def int8_modes(model, qc, ids, mask):
    """Yield ``(mode, phase)`` for the int8 family: FAST on the cached
    weights (uniform grids stay f32, so FAST simulates in f32: the reference
    the JAX package's ``tests/test_glue_serving.py`` holds the int8 modes
    to), then, the cache packed to int8 codes and stripped, int8 packed and
    int8 chained."""
    from .ops.fastpath import pack_dense_caches, strip_packed_params

    cache_weights(model, ids[:2], mask[:2], fast=True)
    yield "int8 fast", FAST
    pack_dense_caches(model, qc)
    strip_packed_params(model)
    yield "int8 packed", PACKED
    yield "int8 chained", CHAINED


def load_examples(args):
    """(task, dev examples, calibration examples, tokenizer)."""
    from .eval import glue

    if args.data_dir:
        task = glue.GLUE_TASKS[args.task.lower()]
        vocab_file = args.vocab_file or os.path.join(args.data_dir, "vocab.txt")
        tok = glue.WordPieceTokenizer.from_file(vocab_file)
        dev_examples = glue.load_examples(args.data_dir, task, "dev")
        try:
            calib_examples = glue.load_examples(args.data_dir, task, "train")
        except FileNotFoundError:
            calib_examples = dev_examples
        return task, dev_examples, calib_examples, tok
    task, dev_examples, tok = glue.synthetic_task(num_examples=8 * args.batch_size,
                                                  seed=args.seed)
    return task, dev_examples, dev_examples, tok


def main(argv=None) -> dict:
    """Parse ``argv``; build, (load ``--model-dir``,) calibrate, evaluate;
    print and return the metrics dict."""
    from .cli import load_weights, select_device
    from .eval import glue
    from .models import bert

    args = build_parser().parse_args(argv)
    device = select_device(args.cuda)
    # full-f32 products: TF32 would move values off the quantization grid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    task, dev_examples, calib_examples, tok = load_examples(args)
    regression = task.labels is None
    spec = dataclasses.replace(bert.BERT_BASE, num_classes=task.num_labels)
    model = bert.QuantizedBert(nlp_qc(args.n_bits, args.fp8_mantissa_bits), spec,
                               generator=torch.Generator().manual_seed(args.seed)).to(device)

    def batches(examples, max_batches=None):
        it = glue.glue_batches(examples, tok, args.batch_size, args.seq_len)
        for i, b in enumerate(it):
            if max_batches is not None and i >= max_batches:
                return
            yield b

    # the init forward sees the first calibration batch with the seeded
    # weights; the ported weights come after it, as in the JAX script
    (ids0, mask0, types0), _, _ = next(batches(calib_examples, 1))
    forward(model, ids0, mask0, types0, ESTIMATE)
    if args.model_dir:
        load_weights("bert_quantized", model, args.model_dir)

    for (ids, mask, types), _, _ in batches(calib_examples, args.num_est_batches):
        forward(model, ids, mask, types, ESTIMATE)

    all_preds, all_labels = [], []
    for (ids, mask, types), y, valid in batches(dev_examples, args.max_eval_batches):
        logits = forward(model, ids, mask, types, FIXED).float().cpu().numpy()
        preds = logits[:, 0] if regression else np.argmax(logits, axis=-1)
        keep = valid > 0
        all_preds.append(preds[keep])
        all_labels.append(y[keep])

    preds = np.concatenate(all_preds)
    labels = np.concatenate(all_labels)
    metrics = glue.compute_glue_metrics(task, preds, labels)
    print(f"task: {task.name} ({len(labels)} examples)")
    print(f"final_metrics: {metrics}")
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
