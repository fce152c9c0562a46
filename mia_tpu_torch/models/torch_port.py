"""Load reference PyTorch checkpoints into the port's models.

Counterpart of ``mia_tpu/models/torch_port.py`` and of
``import_legacy_torch_checkpoint`` in ``mia_tpu/models/legacy_unet.py``. The
JAX package converts a reference ``.pth`` into flax variables; the port's
``UNet`` and ``LegacyUNet`` carry the reference's own parameter names, so
here the import is a loader that validates: it unwraps a ``{"model": ...}``
checkpoint, strips a ``model.`` prefix, turns numpy arrays into tensors and
raises, naming the keys, when the state dict is not this model's (missing
or unexpected keys, a shape that differs).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def checked_state_dict(state_dict: Mapping[str, Any], model: nn.Module,
                       what: str = "checkpoint") -> dict[str, torch.Tensor]:
    """``state_dict`` as tensors under ``model``'s own keys, or a
    ``ValueError`` that says how it differs from ``model.state_dict()``."""
    sd = state_dict["model"] if "model" in state_dict and isinstance(
        state_dict["model"], Mapping) else state_dict
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    sd = {k: v.detach() if hasattr(v, "detach") else torch.from_numpy(np.asarray(v))
          for k, v in sd.items()}
    want = model.state_dict()
    optional = {k for k in want if k.endswith("num_batches_tracked")}
    missing = sorted(set(want) - set(sd) - optional)
    unexpected = sorted(set(sd) - set(want))
    shapes = sorted(f"{k}: {tuple(sd[k].shape)}, expected {tuple(want[k].shape)}"
                    for k in set(sd) & set(want) if tuple(sd[k].shape) != tuple(want[k].shape))
    if missing or unexpected or shapes:
        raise ValueError(
            f"{what} is not a state dict of {type(model).__name__}: "
            f"{len(missing)} missing keys {missing[:3]}, {len(unexpected)} unexpected keys "
            f"{unexpected[:3]}, {len(shapes)} shapes that differ {shapes[:3]}")
    for k in optional - set(sd):
        sd[k] = want[k].clone()
    return sd


def import_torch_unet_checkpoint(state_dict: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Load a reference UNet ``.pth`` state dict (``encoder.levels.{l}.{b}.all.{0,2}``,
    ``decoder.upsamples.{l}``, ``decoder.seg_output``) into the port's ``UNet``."""
    model.load_state_dict(checked_state_dict(state_dict, model, "the UNet checkpoint"))
    return model


def import_legacy_torch_checkpoint(state_dict: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Load a reference ``_UNet`` state dict (the FUGC ``fold_<i>/checkpoint_best.pth``
    files, with or without the ``"model"`` key) into the port's ``LegacyUNet``."""
    model.load_state_dict(checked_state_dict(state_dict, model, "the legacy UNet checkpoint"))
    return model
