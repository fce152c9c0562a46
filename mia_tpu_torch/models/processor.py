"""Pre/post-processing around the UNet, on the tensors' device.

Counterpart of ``mia_tpu/models/processor.py``: bilinear resize to the model
size, nearest resize back, and the optional morphological denoise (pad,
closing fill-hole, opening remove-cc, Gaussian blur + threshold boundary
smoothing, class-priority refill). The JAX package vmaps the denoise over a
batch; here every function takes ``(..., H, W)`` class maps and treats the
leading axes as the batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.morphology import dilate, erode, gaussian_blur_threshold_smooth
from ..ops.resize import resize


class UnetProcessor:
    def __init__(
        self,
        image_size: tuple[int, int] | list[int] | int | None = None,
        dilate_size: int = 5,
        erode_size: int = 5,
        smooth_kernel: int = 7,
        num_denoise_classes: int = 2,
    ):
        if image_size is not None:
            if isinstance(image_size, int):
                image_size = (image_size, image_size)
            image_size = tuple(image_size)
            if len(image_size) < 2:
                image_size = image_size * 2
        self.image_size = image_size
        self.dilate_size = dilate_size
        self.erode_size = erode_size
        self.smooth_kernel = smooth_kernel
        # the reference hardcodes 2 classes in denoise_one_mask; a parameter here
        self.num_denoise_classes = num_denoise_classes

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """Resize ``(..., H, W, C)`` to the model input size (antialiased bilinear)."""
        x = images
        if self.image_size is not None and tuple(x.shape[-3:-1]) != self.image_size:
            x = resize(x, self.image_size, "bilinear", antialias=True)
        if x.dim() == 3:
            x = x[None]
        return x

    def postprocess(self, pred: torch.Tensor, ori_shape: tuple[int, int],
                    do_denoise: bool = False) -> torch.Tensor:
        """Nearest-resize class maps ``(..., H, W)`` back and optionally denoise."""
        masks = pred
        if tuple(masks.shape[-2:]) != tuple(ori_shape):
            masks = resize(masks[..., None], tuple(ori_shape), "nearest")[..., 0]
        if do_denoise:
            masks = self.denoise_one_mask(masks.to(pred.dtype))
        return masks.to(pred.dtype)

    def _clean(self, binary: torch.Tensor) -> torch.Tensor:
        """fill-hole (closing) then remove-cc (opening) on 0/255 masks."""
        filled = erode(dilate(binary, self.dilate_size), self.erode_size)
        return dilate(erode(filled, self.erode_size), self.dilate_size)

    def clean_binary(self, binary: torch.Tensor) -> torch.Tensor:
        """Zero-pad boolean ``(..., H, W)`` masks, clean them as 0/255 floats,
        crop, and smooth the boundary → 0/1 float masks."""
        pad = max(self.dilate_size, self.erode_size)
        m = F.pad(binary.to(torch.float32) * 255.0, (pad, pad, pad, pad))
        m = self._clean(m)[..., pad:-pad, pad:-pad]
        return gaussian_blur_threshold_smooth(m, self.smooth_kernel)

    def denoise_one_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """Denoise ``(..., H, W)`` class maps (the reference's ``denoise_one_mask``):
        the cleaned object mask bounds the foreground, each cleaned class mask
        refills it in class order, what is left takes the last class."""
        num_classes = self.num_denoise_classes
        class_masks = [self.clean_binary(mask > 0) == 0]  # background
        for c in range(1, num_classes):
            class_masks.append(self.clean_binary(mask == c) > 0)
        out = torch.full_like(mask, num_classes)
        for c, class_mask in reversed(list(enumerate(class_masks))):
            out = torch.where(class_mask, c, out)
        return out
