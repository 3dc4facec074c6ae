"""The training loop: QAT epochs with BN re-estimation, evaluation,
checkpoints and a scalar log (port of ``eval/trainer.py``).

A plain loop over ``quant.qat.make_qat_step``'s step, in place on the
model: after each epoch the BN statistics are re-estimated on the training
batches, the model is evaluated, and ``<save_checkpoint_dir>/latest`` is
overwritten (``utils.checkpoint``).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional

from ..quant.qat import (RANGE_PARAM_NAMES, make_optimizer, make_qat_step,
                         release_ranges, trainable_range_params)
from .driver import evaluate, reestimate_bn


class TensorBoardLogger:
    """Scalar logger. It keeps its ``history`` in memory only: the JAX
    package writes TensorBoard files through tensorflow where that is
    installed, and the port depends on neither tensorflow nor tensorboard
    (``log_dir`` is kept for the call's shape)."""

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self.history: list = []

    def scalar(self, tag: str, value: float, step: int):
        self.history.append((tag, float(value), step))

    def flush(self):
        pass


def train_qat(
    model,
    train_batches: Callable[[], Iterable],
    *,
    max_epochs: int = 1,
    eval_batches: Optional[Callable[[], Iterable]] = None,
    optimizer: str = "SGD",
    learning_rate: float = 1e-3,
    momentum: float = 0.9,
    weight_decay: Optional[float] = None,
    learning_rate_schedule: Optional[str] = None,
    sep_quant_optimizer: bool = False,
    quant_optimizer: str = "Adam",
    quant_learning_rate: float = 1e-4,
    grad_scaling: bool = False,
    reestimate_bn_stats: bool = True,
    save_checkpoint_dir: Optional[str] = None,
    tb_logging_dir: Optional[str] = None,
    steps_per_epoch: Optional[int] = None,
    model_kwargs: Optional[dict] = None,
    osc_damp=None,
    osc_freeze=None,
):
    """Run QAT on ``model`` in place; returns (model, history of per-epoch
    metrics: ``epoch``, the epoch's last ``loss`` and the eval metrics)."""
    spe = steps_per_epoch or 1000
    total = spe * max_epochs
    model_opt = make_optimizer(optimizer, learning_rate, momentum, weight_decay,
                               learning_rate_schedule, total, steps_per_epoch=spe)
    quant_opt = (make_optimizer(quant_optimizer, quant_learning_rate)
                 if sep_quant_optimizer else None)
    trainable = (trainable_range_params(model.qc) if hasattr(model, "qc")
                 else RANGE_PARAM_NAMES)
    step, init_state = make_qat_step(
        model, model_opt, quant_opt, grad_scaling=grad_scaling, trainable=trainable,
        model_kwargs=model_kwargs, osc_damp=osc_damp, osc_freeze=osc_freeze,
        total_steps=total)
    state = init_state(model)
    tb = TensorBoardLogger(tb_logging_dir)

    history = []
    global_step = 0
    try:
        for epoch in range(max_epochs):
            for x, y in train_batches():
                state, loss = step(state, x, y)
                tb.scalar("train/loss", float(loss), global_step)
                global_step += 1
                if steps_per_epoch and global_step % steps_per_epoch == 0:
                    break
            if reestimate_bn_stats:
                # BN stats come from the training data, never from the eval set
                reestimate_bn(model, train_batches())
            metrics = {}
            if eval_batches is not None:
                metrics = evaluate(model, eval_batches())
                for k, v in metrics.items():
                    tb.scalar(f"eval/{k}", v, epoch)
            history.append({"epoch": epoch, "loss": float(loss), **metrics})
            if save_checkpoint_dir:
                from ..utils.checkpoint import save_checkpoint

                save_checkpoint(os.path.join(save_checkpoint_dir, "latest"), model)
    finally:
        release_ranges(state)
    tb.flush()
    return model, history
