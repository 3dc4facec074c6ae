"""Eval metrics as accumulators (port of ``eval/metrics.py``): each batch adds
(correct, top-k correct, loss sum, count); the final metrics are ratios."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class MetricState(NamedTuple):
    correct: torch.Tensor      # scalar f32
    topk_correct: torch.Tensor
    loss_sum: torch.Tensor
    count: torch.Tensor

    @classmethod
    def zero(cls, device=None) -> "MetricState":
        z = torch.zeros((), device=device)
        return cls(z, z, z, z)


def update_metrics(state: MetricState, logits, labels, k: int = 5) -> MetricState:
    """Fold one batch of (logits, int labels) into the accumulator."""
    labels = labels.to(torch.int64)
    pred = torch.argmax(logits, dim=-1)
    correct = torch.sum(pred == labels).to(torch.float32)

    topk = torch.argsort(logits, dim=-1)[:, -k:]
    topk_correct = torch.sum(torch.any(topk == labels[:, None], dim=-1)).to(torch.float32)

    # softmax cross-entropy with integer labels
    loss = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels[:, None])[:, 0]
    return MetricState(
        correct=state.correct + correct,
        topk_correct=state.topk_correct + topk_correct,
        loss_sum=state.loss_sum + torch.sum(loss),
        count=state.count + labels.shape[0],
    )


def finalize_metrics(state: MetricState) -> Dict[str, float]:
    n = float(state.count)
    if n == 0:
        return {"top_1_accuracy": 0.0, "top_5_accuracy": 0.0, "loss": 0.0}
    return {
        "top_1_accuracy": float(state.correct) / n,
        "top_5_accuracy": float(state.topk_correct) / n,
        "loss": float(state.loss_sum) / n,
    }
