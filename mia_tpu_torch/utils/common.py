"""Small host-side helpers: ``get_path`` and ``draw_mask``.

Copied from ``mia_tpu/utils/common.py`` (whose package ``__init__`` imports
JAX through its compile-cache helper).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# Color palette for mask overlays (RGB), class 0 is background (no overlay).
_PALETTE = np.array(
    [
        [0, 0, 0],
        [255, 64, 64],
        [64, 255, 64],
        [64, 64, 255],
        [255, 255, 64],
        [255, 64, 255],
        [64, 255, 255],
        [255, 160, 64],
        [160, 64, 255],
    ],
    dtype=np.float32,
)


def get_path(path: str | Path) -> Path:
    """Normalize to an absolute, user-expanded ``Path``."""
    return Path(path).expanduser().resolve()


def draw_mask(
    image: np.ndarray,
    mask: np.ndarray,
    opacity: float = 0.5,
) -> np.ndarray:
    """Alpha-blend a class-index mask over an image.

    Args:
        image: HxW (grayscale) or HxWx3 uint8/float array. Floats are
            assumed to be in [0, 1].
        mask: HxW integer class map.
        opacity: blend factor for mask pixels (class > 0).

    Returns:
        HxWx3 uint8 overlay.
    """
    image = np.asarray(image)
    mask = np.asarray(mask).astype(np.int64)

    if image.dtype != np.uint8:
        image = np.clip(image * 255.0, 0, 255).astype(np.uint8)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    elif image.ndim == 3 and image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)

    colors = _PALETTE[np.clip(mask, 0, len(_PALETTE) - 1)]
    blend = image.astype(np.float32) * (1 - opacity) + colors * opacity
    out = np.where((mask > 0)[..., None], blend, image.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)
