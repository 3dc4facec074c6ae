"""Checkpointing (port of ``utils/checkpoint.py``): a model's whole
``state_dict`` as one ``torch.save`` file: weights, every site's range state
and elected ``mantissa_bits``, BN stats, and the weight caches and packed
codes a serving run installed.

The JAX package saves an orbax checkpoint, which needs JAX to read, so the
port does not read it; a JAX model's variables come across through
``models.bridge.from_jax_variables`` instead.
"""

from __future__ import annotations

import os

import torch

# the file a checkpoint directory holds (not a suffix that the CLI's
# ``load_weights`` sends to ``models.porting``)
CHECKPOINT_FILE = "checkpoint.ckpt"


def checkpoint_path(path: str) -> str:
    """The checkpoint file of ``path``: itself where it is a file, else the
    ``CHECKPOINT_FILE`` of the directory ``path``."""
    path = os.path.abspath(path)
    return path if os.path.isfile(path) else os.path.join(path, CHECKPOINT_FILE)


def save_checkpoint(path: str, model: torch.nn.Module) -> str:
    """Save ``model``'s ``state_dict`` (tensors moved to the CPU) into the
    directory ``path``; returns the file written."""
    os.makedirs(path, exist_ok=True)
    path = checkpoint_path(path)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Restore a checkpoint into a built ``model`` (its shapes; weight
    caches and packed codes fill the buffers a fresh model has left empty),
    read with ``weights_only=True``. Returns the model."""
    state = torch.load(checkpoint_path(path), map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model
