"""LoRA plumbing for the SAM image encoder (counterpart of
``mia_tpu/models/sam/lora.py``).

The adapters are parameters of the encoder itself
(``Attention(lora_rank=r)``: ``lora_a_{q,v}``, ``lora_b_{q,v}``). Here:

- :func:`lora_trainable_mask` names what trains: everything outside the
  image encoder, and the LoRA adapters inside it;
  :func:`freeze_wrt_mask` applies it as ``requires_grad`` and returns the
  trainable parameters (the optimizer is built over those alone, the
  counterpart of the JAX package's ``optax.multi_transform`` freeze);
- :func:`lora_state_dict` / :func:`load_lora_state_dict`: the LoRA
  checkpoint, the adapters plus every entry outside the frozen encoder, as
  a torch state dict under the model's (reference) names;
- :func:`write_lora_msgpack` / :func:`read_lora_checkpoint`: that checkpoint
  on disk, as the JAX package's ``lora.msgpack`` (the same entries as its
  ``lora_state_dict``: flax params, through ``sam_flax_bridge``), or a torch
  ``lora.pth`` read as it is.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from ...utils.flax_msgpack import read_flax_msgpack, write_flax_msgpack
from ..sam_flax_bridge import sam_state_dict_from_flax, sam_state_dict_to_flax


def _is_lora(name: str) -> bool:
    return any(part.startswith(("lora_a_", "lora_b_")) for part in name.split("."))


def _in_encoder(name: str) -> bool:
    return name.split(".", 1)[0] == "image_encoder"


def _kept(name: str) -> bool:
    return not _in_encoder(name) or _is_lora(name)


def lora_trainable_mask(model: nn.Module) -> dict[str, bool]:
    """Parameter name → trainable."""
    return {name: _kept(name) for name, _ in model.named_parameters()}


def freeze_wrt_mask(model: nn.Module, mask: dict[str, bool]) -> list[nn.Parameter]:
    """Set ``requires_grad`` from ``mask``; return the trainable parameters."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trainable.append(p)
    return trainable


def lora_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """Adapters + every parameter and buffer outside the encoder, on the CPU."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items() if _kept(k)}


def load_lora_state_dict(model: nn.Module, state: dict[str, torch.Tensor]) -> None:
    """Load a LoRA checkpoint into ``model`` (the frozen encoder untouched);
    raise if it lacks an entry the checkpoint must hold or has a stranger."""
    expected = {k for k in model.state_dict() if _kept(k)}
    missing, unexpected = expected - set(state), set(state) - expected
    if missing or unexpected:
        raise KeyError(f"LoRA checkpoint mismatch: missing {sorted(missing)[:5]}, "
                       f"unexpected {sorted(unexpected)[:5]}")
    model.load_state_dict(state, strict=False)


def write_lora_msgpack(model: nn.Module, path: str | Path) -> None:
    """Write ``model``'s LoRA checkpoint as the JAX package's ``lora.msgpack``."""
    write_flax_msgpack(sam_state_dict_to_flax(lora_state_dict(model)), path)


def read_lora_checkpoint(path: str | Path) -> dict[str, torch.Tensor]:
    """A LoRA checkpoint file as a state dict: a flax ``lora.msgpack`` of
    either package, or a torch ``lora.pth``."""
    path = Path(path)
    if path.suffix in (".pth", ".pt"):
        return torch.load(path, map_location="cpu")
    return sam_state_dict_from_flax({"params": read_flax_msgpack(path)})
