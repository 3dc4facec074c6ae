"""GLUE data pipeline: TSV parsing, WordPiece tokenization, task metrics
(port of ``eval/glue.py``, a copy: the module is numpy and the standard
library only, and the port imports nothing of the JAX package).

The nine GLUE tasks in their canonical TSV layouts, a self-contained BERT
WordPiece tokenizer (reads a local ``vocab.txt``; the uncased conventions
of ``transformers.BertTokenizer``), fixed-shape padded batches (one shape
for every batch, the last one padded with copies of its last row), and the
standard GLUE metrics (accuracy, F1, Matthews correlation, Pearson /
Spearman).

Everything reads from local files; ``synthetic_task`` generates a
deterministic stand-in corpus and vocab when no dataset is on disk.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import unicodedata
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Task registry (canonical glue_data TSV layouts)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GlueTask:
    name: str
    text_a: int                    # column index of sentence A
    text_b: Optional[int]          # column index of sentence B (None = single)
    label: int                     # column index of the label
    labels: Optional[Tuple[str, ...]]  # None => regression (STS-B)
    has_header: bool
    metrics: Tuple[str, ...]
    dev_file: str = "dev.tsv"
    train_file: str = "train.tsv"

    @property
    def num_labels(self) -> int:
        return 1 if self.labels is None else len(self.labels)


GLUE_TASKS: Dict[str, GlueTask] = {
    "cola": GlueTask("cola", 3, None, 1, ("0", "1"), False, ("matthews",)),
    "sst-2": GlueTask("sst-2", 0, None, 1, ("0", "1"), True, ("accuracy",)),
    "mrpc": GlueTask("mrpc", 3, 4, 0, ("0", "1"), True, ("accuracy", "f1")),
    "sts-b": GlueTask("sts-b", 7, 8, 9, None, True, ("pearson", "spearman")),
    "qqp": GlueTask("qqp", 3, 4, 5, ("0", "1"), True, ("accuracy", "f1")),
    "mnli": GlueTask("mnli", 8, 9, -1,
                     ("contradiction", "entailment", "neutral"), True,
                     ("accuracy",), dev_file="dev_matched.tsv"),
    "mnli-mm": GlueTask("mnli-mm", 8, 9, -1,
                        ("contradiction", "entailment", "neutral"), True,
                        ("accuracy",), dev_file="dev_mismatched.tsv"),
    "qnli": GlueTask("qnli", 1, 2, -1, ("entailment", "not_entailment"), True,
                     ("accuracy",)),
    "rte": GlueTask("rte", 1, 2, -1, ("entailment", "not_entailment"), True,
                    ("accuracy",)),
    "wnli": GlueTask("wnli", 1, 2, -1, ("0", "1"), True, ("accuracy",)),
}


def read_tsv(path: str) -> List[List[str]]:
    with open(path, encoding="utf-8-sig") as f:
        return list(csv.reader(f, delimiter="\t", quotechar=None,
                               quoting=csv.QUOTE_NONE))


@dataclasses.dataclass(frozen=True)
class GlueExample:
    text_a: str
    text_b: Optional[str]
    label: float  # class index, or the raw score for regression


def load_examples(data_dir: str, task: GlueTask, split: str = "dev"
                  ) -> List[GlueExample]:
    """Parse <data_dir>/<file> into examples; malformed rows are skipped."""
    fname = task.dev_file if split == "dev" else task.train_file
    rows = read_tsv(os.path.join(data_dir, fname))
    if task.has_header and rows:
        rows = rows[1:]
    out: List[GlueExample] = []
    min_cols = max(task.text_a, task.text_b or 0,
                   task.label if task.label >= 0 else 0) + 1
    for row in rows:
        if len(row) < min_cols:
            continue
        raw = row[task.label]
        if task.labels is None:
            try:
                label = float(raw)
            except ValueError:
                continue
        else:
            if raw not in task.labels:
                continue
            label = float(task.labels.index(raw))
        out.append(GlueExample(
            text_a=row[task.text_a],
            text_b=row[task.text_b] if task.text_b is not None else None,
            label=label,
        ))
    return out


# ---------------------------------------------------------------------------
# WordPiece tokenizer (BERT-uncased conventions)
# ---------------------------------------------------------------------------


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    """BERT basic+WordPiece tokenization from a local vocab.txt.

    Mirrors ``transformers.BertTokenizer`` (uncased defaults): NFD accent
    stripping, lowercasing, punctuation/CJK splitting, greedy longest-match
    WordPiece with ``##`` continuations and per-word length cap 100.
    """

    def __init__(self, vocab: Sequence[str], do_lower_case: bool = True,
                 unk_token: str = "[UNK]"):
        self.vocab = {tok: i for i, tok in enumerate(vocab)}
        self.inv_vocab = list(vocab)
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        for tok in ("[PAD]", "[CLS]", "[SEP]", unk_token):
            if tok not in self.vocab:
                raise ValueError(f"vocab missing special token {tok!r}")
        self.pad_id = self.vocab["[PAD]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.unk_id = self.vocab[unk_token]

    @classmethod
    def from_file(cls, vocab_file: str, **kw) -> "WordPieceTokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f if line.strip()]
        return cls(vocab, **kw)

    # -- basic tokenization ------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            # \t\n\r are whitespace (checked before the control-char skip,
            # matching BertTokenizer._is_whitespace/_is_control precedence)
            if ch in ("\t", "\n", "\r") or unicodedata.category(ch) == "Zs":
                out.append(" ")
                continue
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) == "Cc":
                continue
            if _is_cjk(cp):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        tokens: List[str] = []
        for word in text.split():
            if self.do_lower_case:
                word = word.lower()
                word = "".join(ch for ch in unicodedata.normalize("NFD", word)
                               if unicodedata.category(ch) != "Mn")
            cur: List[str] = []
            for ch in word:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > 100:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                cand = word[start:end]
                if start > 0:
                    cand = "##" + cand
                if cand in self.vocab:
                    piece = cand
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]


def encode_pair(tok: WordPieceTokenizer, text_a: str,
                text_b: Optional[str], max_len: int
                ) -> Tuple[List[int], List[int], List[int]]:
    """[CLS] A [SEP] (B [SEP]) with longest-first pair truncation + padding.

    Returns (input_ids, attention_mask, token_type_ids), each length max_len.
    """
    a = tok.convert_tokens_to_ids(tok.tokenize(text_a))
    b = tok.convert_tokens_to_ids(tok.tokenize(text_b)) if text_b else None
    budget = max_len - (3 if b is not None else 2)
    if b is None:
        a = a[:budget]
        ids = [tok.cls_id] + a + [tok.sep_id]
        types = [0] * len(ids)
    else:
        while len(a) + len(b) > budget:
            (a if len(a) >= len(b) else b).pop()
        ids = [tok.cls_id] + a + [tok.sep_id] + b + [tok.sep_id]
        types = [0] * (len(a) + 2) + [1] * (len(b) + 1)
    mask = [1] * len(ids)
    pad = max_len - len(ids)
    return ids + [tok.pad_id] * pad, mask + [0] * pad, types + [0] * pad


def glue_batches(
    examples: Sequence[GlueExample],
    tok: WordPieceTokenizer,
    batch_size: int,
    max_len: int = 128,
    pad_final: bool = True,
) -> Iterator[Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray],
                    np.ndarray, np.ndarray]]:
    """Yield ((ids, mask, type_ids), labels, valid) fixed-shape batches.

    ``valid`` flags real rows; the final partial batch is padded with copies
    of its last row (one shape for every batch) and the pad
    rows carry valid=0 so metrics ignore them.
    """
    buf_x, buf_y = [], []

    def emit(n_valid: int):
        ids = np.asarray([x[0] for x in buf_x], np.int32)
        mask = np.asarray([x[1] for x in buf_x], np.int32)
        types = np.asarray([x[2] for x in buf_x], np.int32)
        y = np.asarray(buf_y, np.float32)
        valid = (np.arange(len(buf_x)) < n_valid).astype(np.float32)
        return (ids, mask, types), y, valid

    for ex in examples:
        buf_x.append(encode_pair(tok, ex.text_a, ex.text_b, max_len))
        buf_y.append(ex.label)
        if len(buf_x) == batch_size:
            yield emit(batch_size)
            buf_x, buf_y = [], []
    if buf_x:
        n = len(buf_x)
        if pad_final:
            while len(buf_x) < batch_size:
                buf_x.append(buf_x[-1])
                buf_y.append(buf_y[-1])
        yield emit(n)


# ---------------------------------------------------------------------------
# GLUE metrics (numpy; computed host-side over gathered predictions)
# ---------------------------------------------------------------------------


def _confusion(preds: np.ndarray, labels: np.ndarray):
    tp = float(np.sum((preds == 1) & (labels == 1)))
    tn = float(np.sum((preds == 0) & (labels == 0)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    return tp, tn, fp, fn


def accuracy_score(preds, labels) -> float:
    return float(np.mean(np.asarray(preds) == np.asarray(labels)))


def f1_score(preds, labels) -> float:
    tp, _, fp, fn = _confusion(np.asarray(preds), np.asarray(labels))
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


def matthews_corrcoef(preds, labels) -> float:
    tp, tn, fp, fn = _confusion(np.asarray(preds), np.asarray(labels))
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom) if denom else 0.0


def pearson_corr(x, y) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xc, yc = x - x.mean(), y - y.mean()
    denom = np.sqrt((xc ** 2).sum() * (yc ** 2).sum())
    return float((xc * yc).sum() / denom) if denom else 0.0


def _ranks(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties share the mean rank), as scipy.stats.rankdata."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    sx = x[order]
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def spearman_corr(x, y) -> float:
    return pearson_corr(_ranks(np.asarray(x, np.float64)),
                        _ranks(np.asarray(y, np.float64)))


def compute_glue_metrics(task: GlueTask, preds: np.ndarray,
                         labels: np.ndarray) -> Dict[str, float]:
    """preds: argmax class ids (classification) or scores (regression)."""
    out: Dict[str, float] = {}
    for m in task.metrics:
        if m == "accuracy":
            out["accuracy"] = accuracy_score(preds, labels)
        elif m == "f1":
            out["f1"] = f1_score(preds, labels)
        elif m == "matthews":
            out["matthews"] = matthews_corrcoef(preds, labels)
        elif m == "pearson":
            out["pearson"] = pearson_corr(preds, labels)
        elif m == "spearman":
            out["spearman"] = spearman_corr(preds, labels)
    return out


# ---------------------------------------------------------------------------
# Synthetic stand-in (zero-egress CI)
# ---------------------------------------------------------------------------

_SYNTH_WORDS = ("the movie was great terrible plot acting fine story dull "
                "brilliant boring script superb weak cast strong ending "
                "slow fast deeply truly").split()


def synthetic_vocab() -> List[str]:
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += sorted(set(_SYNTH_WORDS))
    vocab += ["##s", "##ly", "##ing", ".", ",", "!", "?"]
    return vocab


def synthetic_task(num_examples: int = 64, seed: int = 10,
                   pair: bool = False) -> Tuple[GlueTask,
                                                List[GlueExample],
                                                WordPieceTokenizer]:
    """A deterministic sentiment-ish task: label 1 iff 'great' or 'brilliant'
    appears. Learnable-in-principle, and exercises the full pipeline."""
    rng = np.random.default_rng(seed)
    pos = {"great", "brilliant", "superb"}
    examples = []
    for _ in range(num_examples):
        words = list(rng.choice(_SYNTH_WORDS, size=int(rng.integers(3, 12))))
        label = float(bool(pos & set(words)))
        text = " ".join(words) + "."
        examples.append(GlueExample(
            text_a=text,
            text_b=" ".join(rng.choice(_SYNTH_WORDS, size=4)) if pair else None,
            label=label,
        ))
    task = GlueTask("synthetic", 0, 1 if pair else None, 2, ("0", "1"),
                    True, ("accuracy", "f1"))
    return task, examples, WordPieceTokenizer(synthetic_vocab())
