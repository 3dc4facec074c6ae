"""Fusable activation registry (port of ``ops/activations.py``): plain torch
callables keyed by name."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def hard_sigmoid(x):
    # torch F.hardsigmoid: clip(x/6 + 1/2, 0, 1)
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hard_swish(x):
    return x * hard_sigmoid(x)


def swish(x):
    return x * torch.sigmoid(x)


def _leaky_relu(x):
    # jax.nn.leaky_relu's default slope
    return F.leaky_relu(x, negative_slope=0.01)


ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": relu6,
    "hardtanh": hardtanh,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    # the exact erf form, as torch nn.GELU's default and the JAX package's
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "prelu": _leaky_relu,
    "swish": swish,
    "hardswish": hard_swish,
    "hardsigmoid": hard_sigmoid,
}


def get_activation(name: Optional[str]) -> Optional[Callable]:
    if name is None:
        return None
    return ACTIVATIONS[name]
