"""ResizeLongestSide (counterpart of ``mia_tpu/models/sam/transforms.py``):
resize images, point coordinates and boxes to the encoder's long side."""

from __future__ import annotations

from copy import deepcopy
from typing import Tuple

import numpy as np
import torch

from ...ops.resize import resize


class ResizeLongestSide:
    def __init__(self, target_length: int):
        self.target_length = target_length

    @staticmethod
    def get_preprocess_shape(oldh: int, oldw: int, long_side_length: int) -> Tuple[int, int]:
        scale = long_side_length * 1.0 / max(oldh, oldw)
        newh, neww = oldh * scale, oldw * scale
        return int(newh + 0.5), int(neww + 0.5)

    def apply_image(self, image: np.ndarray) -> np.ndarray:
        """(H, W, C) array → resized array of the same dtype (antialiased
        bilinear on the CPU, truncated back to an integer dtype)."""
        target = self.get_preprocess_shape(image.shape[0], image.shape[1], self.target_length)
        out = resize(torch.from_numpy(np.asarray(image, np.float32)), target, "bilinear",
                     antialias=True)
        return out.numpy().astype(image.dtype)

    def apply_coords(self, coords: np.ndarray, original_size) -> np.ndarray:
        old_h, old_w = original_size
        new_h, new_w = self.get_preprocess_shape(old_h, old_w, self.target_length)
        coords = deepcopy(coords).astype(float)
        coords[..., 0] = coords[..., 0] * (new_w / old_w)
        coords[..., 1] = coords[..., 1] * (new_h / old_h)
        return coords

    def apply_boxes(self, boxes: np.ndarray, original_size) -> np.ndarray:
        boxes = self.apply_coords(boxes.reshape(-1, 2, 2), original_size)
        return boxes.reshape(-1, 4)
