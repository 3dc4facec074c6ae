"""QAT: range learning, parameter partitioning, optimizers, train step
(port of ``quant/qat.py``).

The JAX package differentiates a pure step over the ``params`` and
``quant`` collections; here the model's own tensors are trained in place:

* the ranges stay the sites' buffers, under the JAX state keys that
  ``models.bridge``, the checkpoints and ``--model-dir`` rely on.
  ``init_state`` makes the trainable ones require grad, so every forward
  that reads them builds their gradient, the ``ESTIMATE`` write (in place,
  under ``torch.no_grad()``) works on them as on any buffer, and the
  derived-once caches of the serving paths, keyed on the tensors'
  versions, see each optimizer update. A ``torch.func.functional_call``
  over a dict of leaves would rebind the tensors on every call and defeat
  those caches;
* ``partition_variables`` splits the model's ``state_dict`` names into
  (model parameters, trainable ranges, the rest), as the JAX function
  splits its variables;
* ``make_optimizer`` gives an :class:`OptimizerSpec`, which builds a
  ``torch.optim`` optimizer over a group of tensors: ``optax.sgd(lr,
  momentum)`` is ``SGD(momentum, dampening=0)``, ``chain(
  add_decayed_weights(wd), adam)`` is ``Adam(weight_decay=wd)`` (L2, not
  AdamW), and the learning rate of each step is the schedule's value at
  the step count, as optax reads it.

The JAX step also takes the 5-tuple state of the days before the
oscillation carry, so that states saved then keep loading; the port has no
such saved state to read and takes only :class:`QATState`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import OscDampConfig, OscFreezeConfig, QuantConfig
from .sites import QuantPhase, QuantSite

RANGE_PARAM_NAMES = ("maxval", "mantissa_bits", "delta", "zero_float")


class QATState(NamedTuple):
    """Train-step carry: the model's tensors by ``state_dict`` name (live:
    the step updates them in place), the two optimizers and the
    oscillation carry ``{"step": int, "freeze": FreezeState}``."""

    model_params: dict
    quant_train: dict
    rest: dict
    m_opt_state: "ScheduledOptimizer"
    q_opt_state: "ScheduledOptimizer"
    osc: dict


def trainable_range_params(qc) -> Tuple[str, ...]:
    """Which range params QAT may train, per the config's learn flags: a
    uniform site's ``delta`` and ``zero_float`` always, an FP site's
    ``maxval`` and ``mantissa_bits`` only under their learn flags."""
    names = ["delta", "zero_float"]
    if qc.fp8.learn_maxval:
        names.append("maxval")
    if qc.fp8.learn_mantissa_bits:
        names.append("mantissa_bits")
    return tuple(names)


def _range_names(model: torch.nn.Module, trainable: Tuple[str, ...]) -> set:
    """``state_dict`` names of the sites' quantizer state keys in ``trainable``."""
    return {f"{path}.{k}" if path else k
            for path, m in model.named_modules() if isinstance(m, QuantSite)
            for k in m.q_keys if k in trainable}


def partition_variables(model: torch.nn.Module,
                        trainable: Tuple[str, ...] = RANGE_PARAM_NAMES
                        ) -> Tuple[dict, dict, dict]:
    """Split ``model``'s tensors, by ``state_dict`` name, into
    (model_params, quant_params, rest): its parameters; the ``trainable``
    keys of its sites' quantizer state (see ``trainable_range_params``); and
    everything else (estimator state, BN stats, integer flags, caches), which
    is not optimized. The values are the model's own tensors."""
    ranges = _range_names(model, trainable)
    model_params, quant_train, rest = {}, {}, {}
    for name, t in model.state_dict(keep_vars=True).items():
        if isinstance(t, torch.nn.Parameter):
            model_params[name] = t
        elif name in ranges:
            quant_train[name] = t
        else:
            rest[name] = t
    return model_params, quant_train, rest


def merge_variables(model_params: dict, quant_train: dict, rest: dict) -> dict:
    """Inverse of ``partition_variables``: one ``state_dict``."""
    return {**rest, **quant_train, **model_params}


def _piecewise_constant(base_lr: float, boundaries: dict) -> Callable[[int], float]:
    """``optax.piecewise_constant_schedule`` in its f32 arithmetic: each
    boundary's scale applies from the count equal to the boundary on."""
    def schedule(count: int) -> float:
        v = np.float32(base_lr)
        for threshold, scale in sorted(boundaries.items()):
            ind = np.float32(max(0.0, float(np.sign(threshold - count))))
            v = v * ind + (np.float32(1) - ind) * np.float32(scale) * v
        return float(v)
    return schedule


def _cosine_decay(base_lr: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``'s closed form, in f32."""
    def schedule(count: int) -> float:
        c = np.float32(min(count, decay_steps))
        cos = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * c
                                                       / np.float32(decay_steps)))
        decayed = np.float32(1 - alpha) * cos + np.float32(alpha)
        return float(np.float32(base_lr) * decayed)
    return schedule


def make_schedule(base_lr: float, schedule: Optional[str], total_steps: int,
                  steps_per_epoch: int = 1) -> Union[float, Callable[[int], float]]:
    """'MultiStepLR:10:20:40' or 'cosine:1e-4'; ``base_lr`` itself without
    a schedule. MultiStepLR milestones are epochs: they scale by
    ``steps_per_epoch`` to become optimizer-step boundaries, where the
    rate drops tenfold. Cosine decays to ``final`` at ``total_steps``
    (optax's closed form with ``alpha = final / base_lr``)."""
    if not schedule:
        return base_lr
    kind, *rest = schedule.split(":")
    if kind == "MultiStepLR":
        return _piecewise_constant(base_lr, {int(m) * steps_per_epoch: 0.1 for m in rest})
    if kind == "cosine":
        final = float(rest[0]) if rest else 0.0
        return _cosine_decay(base_lr, total_steps, final / base_lr if base_lr else 0.0)
    raise ValueError(f"unknown schedule {schedule}")


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer whose learning rate follows a schedule
    of the update count (``count`` updates done so far), as optax's does."""

    def __init__(self, optimizer: torch.optim.Optimizer, lr):
        self.optimizer = optimizer
        self.lr = lr
        self.count = 0

    def step(self):
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """SGD (with momentum) or Adam, L2 weight decay and a schedule: what
    ``make_optimizer`` returns. Calling it on tensors builds a
    :class:`ScheduledOptimizer` over them."""

    name: str             # "SGD" | "ADAM"
    lr: object
    momentum: float
    weight_decay: float

    def __call__(self, params) -> ScheduledOptimizer:
        params = list(params)
        # an empty group (a model with no trainable range) still steps
        params = params or [torch.zeros(0, requires_grad=True)]
        first = self.lr(0) if callable(self.lr) else self.lr
        if self.name == "SGD":
            opt = torch.optim.SGD(params, lr=first, momentum=self.momentum,
                                  dampening=0.0, weight_decay=self.weight_decay)
        else:
            opt = torch.optim.Adam(params, lr=first, weight_decay=self.weight_decay)
        return ScheduledOptimizer(opt, self.lr)


def make_optimizer(
    name: str = "SGD",
    learning_rate: float = 0.01,
    momentum: float = 0.9,
    weight_decay: Optional[float] = None,
    schedule: Optional[str] = None,
    total_steps: int = 10_000,
    steps_per_epoch: int = 1,
) -> OptimizerSpec:
    """SGD/Adam factory."""
    if name.upper() not in ("SGD", "ADAM"):
        raise ValueError(f"unknown optimizer {name}")
    lr = make_schedule(learning_rate, schedule, total_steps, steps_per_epoch)
    return OptimizerSpec(name.upper(), lr, momentum, weight_decay or 0.0)


def check_trainable(model: torch.nn.Module, qc: Optional[QuantConfig]):
    """Refuse a model whose training forward would read a weight cache or
    reach a kernel: none has a gradient. A filled cache (``w_q``, packed
    codes) would stand in for the kernel and drop it from the gradient; the
    approximate multiplier runs K3 (or its oracle, bit arithmetic)."""
    from ..ops.layers import CACHE_KEYS

    cached = sorted({k for m in model.modules() for k in CACHE_KEYS
                     if getattr(m, "_buffers", {}).get(k) is not None})
    if cached:
        raise ValueError(f"QAT needs the model without weight caches or packed codes "
                         f"(found {cached}): the cached weights have no gradient")
    if qc is not None and qc.run_method.approx_flag:
        raise ValueError("QAT cannot train through the approximate multiplier: its "
                         "kernel (K3) and oracle have no gradient")


def _zero_missing_grads(tensors):
    """A tensor the loss does not reach gets a zero gradient, as under
    ``jax.grad`` (weight decay and momentum still move it)."""
    for t in tensors:
        if t.grad is None:
            t.grad = torch.zeros_like(t)


def make_qat_step(
    model,
    model_opt: OptimizerSpec,
    quant_opt: Optional[OptimizerSpec] = None,
    *,
    grad_scaling: bool = False,
    estimate_ranges_train: bool = False,
    trainable: Tuple[str, ...] = RANGE_PARAM_NAMES,
    model_kwargs: Optional[dict] = None,
    qc: Optional[QuantConfig] = None,
    osc_damp: Optional[OscDampConfig] = None,
    osc_freeze: Optional[OscFreezeConfig] = None,
    total_steps: int = 10_000,
):
    """Build a QAT train step over (model params, range params); returns
    ``(step, init_state)``: ``init_state(model)`` partitions the model and
    builds the optimizers, ``step(state, x, y)`` runs one update in place
    and returns ``(state, loss)``.

    By default the ranges are frozen values that receive gradients (the
    ``FIXED`` phase). With ``estimate_ranges_train`` the ``ESTIMATE`` phase
    runs instead: the range estimators keep updating from every training
    batch, and their values override the optimizer's updates to the ranges.
    ``grad_scaling`` applies LSQ's gradient scaling to the uniform ranges.

    ``osc_damp`` / ``osc_freeze`` enable the oscillation dampening loss and
    the EMA-frequency freezer (``quant.oscillations``); both read the
    weight-quantizer states through ``qc`` (default ``model.qc``), and
    ``total_steps`` drives their cosine annealing.
    """
    from . import oscillations as osc

    quant_opt = quant_opt or model_opt
    qp = QuantPhase(phase="estimate" if estimate_ranges_train else "fixed",
                    grad_scaling=grad_scaling)
    model_kwargs = model_kwargs or {}
    damp_on = osc_damp is not None and osc_damp.enabled
    freeze_on = osc_freeze is not None and osc_freeze.enabled
    if qc is None:
        qc = getattr(model, "qc", None)
        if (damp_on or freeze_on) and qc is None:
            raise ValueError("oscillation dampening/freezing needs qc")
    wq_cfg = qc.weight_quantizer() if qc is not None else None

    def step(state: QATState, x, y):
        model_params, quant_train, rest, m_opt, q_opt, osc_state = state
        osc_step = osc_state["step"]
        dev = next(iter(model_params.values())).device
        x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
        y = torch.as_tensor(y).to(device=dev, dtype=torch.long)
        tensors = [*model_params.values(), *quant_train.values()]
        for t in tensors:
            t.grad = None
        logits = model(x, qp, **model_kwargs)
        loss = F.cross_entropy(logits.to(torch.float32), y)
        if damp_on:
            # a 0-dim host tensor: it joins the device's product as it is
            w = osc.dampening_weight(osc_damp, osc_step, total_steps)
            loss = loss + w * osc.dampening_loss(model, wq_cfg, osc_damp.aggregation)
        loss.backward()
        _zero_missing_grads(tensors)
        with torch.no_grad():
            # the estimators' writes of this forward, which override the
            # optimizer's update to the ranges
            estimated = ({k: t.detach().clone() for k, t in quant_train.items()}
                         if estimate_ranges_train else None)
            before = osc.kernels(model, osc_state["freeze"]) if freeze_on else None
            m_opt.step()
            if freeze_on:
                osc.mask_frozen_updates(osc_state["freeze"], model, before)
            q_opt.step()
            if estimated is not None:
                for k, t in quant_train.items():
                    t.copy_(estimated[k])
            if freeze_on:
                thr = osc.freeze_threshold(osc_freeze, osc_step, total_steps)
                fstate = osc.freeze_update(osc_freeze, wq_cfg, osc_state["freeze"], model, thr)
                osc.project_frozen(wq_cfg, fstate, model)
                osc_state = dict(osc_state, freeze=fstate)
        for t in tensors:
            t.grad = None
        osc_state = dict(osc_state, step=osc_step + 1)
        return (QATState(model_params, quant_train, rest, m_opt, q_opt, osc_state),
                loss.detach())

    def init_state(model_: torch.nn.Module) -> QATState:
        # model_ is the model the step trains (the JAX package passes its
        # variables here)
        check_trainable(model_, qc)
        model_params, quant_train, rest = partition_variables(model_, trainable)
        for t in quant_train.values():
            t.requires_grad_(True)
        osc_state = {"step": 0}
        if freeze_on:
            osc_state["freeze"] = osc.freeze_init(osc_freeze, wq_cfg, model_)
        return QATState(model_params, quant_train, rest,
                        model_opt(model_params.values()), quant_opt(quant_train.values()),
                        osc_state)

    return step, init_state


def release_ranges(state: QATState):
    """Turn the ranges back into plain buffers (``requires_grad`` off) once
    training ends, so serving forwards build no graph through them."""
    for t in state.quant_train.values():
        t.requires_grad_(False)
