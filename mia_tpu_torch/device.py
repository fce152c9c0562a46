"""Device resolution, compute dtypes and float32 precision settings.

``cuda`` is the default everywhere. Asking for ``cuda`` on a machine without
a card raises: the port never falls back to the CPU on its own. The CPU must
be asked for by name (``--device cpu``).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Map a ``--device`` value to a ``torch.device``; raise if unusable."""
    try:
        dev = torch.device("cuda" if device is None else device)
    except RuntimeError as e:
        raise ValueError(f"unsupported device {str(device)!r} (use cuda or cpu)") from e
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass --device cpu to run on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device with index {dev.index}")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (use cuda or cpu)")
    return dev


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_compute_dtype(name: str | torch.dtype) -> torch.dtype:
    """Map a ``--compute-dtype`` value (``float32`` or ``bfloat16``, or the
    ``torch.dtype`` itself) to the ``torch.dtype`` the models compute in."""
    if isinstance(name, torch.dtype):
        if name not in COMPUTE_DTYPES.values():
            raise ValueError(f"unsupported compute dtype {name} (use float32 or bfloat16)")
        return name
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"unsupported compute dtype {name!r} (use float32 or bfloat16)")
    return COMPUTE_DTYPES[name]


def set_compute_precision(compute_dtype: str = "float32") -> None:
    """Pin the float32 math mode of cuDNN convolutions and cuBLAS matmuls.

    ``float32`` stores parameters and activations in float32 and sets:

    - ``torch.backends.cudnn.allow_tf32 = True``: convolutions run on the
      tensor cores in TF32 (10-bit mantissa inputs, float32 accumulation).
      This is cuDNN's default, and so how the reference PyTorch stack
      trained; the JAX package's float32 convolutions on a TPU ran one
      bfloat16 pass at XLA's default precision, coarser still. Full float32
      convolutions take about 4x longer on an H100 (see PERF.md).
    - ``torch.backends.cuda.matmul.allow_tf32 = False``: matmuls stay full
      float32, so the eval pipeline's resize matrices (one-hot label maps,
      bilinear image weights) are applied exactly.

    ``bfloat16`` keeps float32 parameters and computes the models'
    activations in bfloat16 (each module's ``compute_dtype``, flax's
    ``dtype``); what stays float32 (normalisation statistics, losses, the
    resize matrices, the optimizer) takes the same two settings.
    """
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unsupported compute dtype {compute_dtype!r} (use float32 or bfloat16)")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
