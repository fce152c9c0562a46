"""Legacy fixed UNet in PyTorch with the JAX package's semantics.

Counterpart of ``mia_tpu/models/legacy_unet.py``: the classic 64→1024
max-pool UNet that the FUGC-2025 fold checkpoints target. Bias-free 3×3
convolutions, BatchNorm (flax's running-statistics update), LeakyReLU(0.01),
``nn.ConvTranspose2d`` upsampling or bilinear ``align_corners=True``
upsampling with halved mid-channels, the upsampled map zero-padded to its
skip, a 1×1 head (``n_classes=None`` returns the last features).

- Parameter names are the reference ``_UNet``'s (``inc.double_conv.{0,1,3,4}``,
  ``down{i}.maxpool_conv.1.double_conv``, ``up{i}.up``, ``up{i}.conv``,
  ``outc.conv``), so the fold checkpoints load as they are
  (``models/torch_port.py::import_legacy_torch_checkpoint``).
- The public layout is NHWC like the JAX package; inside, NCHW views.
- Initialisation follows flax's: lecun-normal kernels, zero biases.
- ``compute_dtype`` is flax's ``dtype=`` as in ``unet.py``: float32
  parameters cast at each call, bfloat16 activations, float32 BatchNorm
  statistics.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, ConvTranspose2d
from .unet import FlaxBatchNorm2d, _lecun_normal_


@dataclasses.dataclass(frozen=True)
class LegacyUNetConfig:
    n_channels: int = 3
    n_classes: int | None = 3
    bilinear: bool = False
    width: int = 64  # the reference hard-codes 64; scalable for tests
    compute_dtype: torch.dtype = torch.float32  # the activations' dtype; parameters stay float32


class DoubleConv(nn.Module):
    """(conv 3×3 → BatchNorm → LeakyReLU) twice."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: int | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = mid_channels or out_channels
        layers = []
        for cin, cout in ((in_channels, mid), (mid, out_channels)):
            conv = Conv2d(cin, cout, 3, padding=1, bias=False, compute_dtype=compute_dtype)
            _lecun_normal_(conv.weight, cin * 9)
            layers += [conv, FlaxBatchNorm2d(cout), nn.LeakyReLU(0.01)]
        self.double_conv = nn.Sequential(*layers)

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), DoubleConv(in_channels, out_channels, compute_dtype=compute_dtype))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    """Upsample ``x1``, pad it to the skip ``x2``, concatenate (skip first), DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int, bilinear: bool,
                 compute_dtype: torch.dtype):
        super().__init__()
        if bilinear:
            self.up = nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True)
            self.conv = DoubleConv(in_channels, out_channels, in_channels // 2, compute_dtype)
        else:
            self.up = ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2,
                                      compute_dtype=compute_dtype)
            # flax ConvTranspose kernel (2, 2, cin, cout): fan_in = 4 * cin
            _lecun_normal_(self.up.weight, 4 * in_channels)
            nn.init.zeros_(self.up.bias)
            self.conv = DoubleConv(in_channels, out_channels, compute_dtype=compute_dtype)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dy, dx = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1, compute_dtype=compute_dtype)
        _lecun_normal_(self.conv.weight, in_channels)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x):
        return self.conv(x)


class LegacyUNet(nn.Module):
    """``forward(x (B, H, W, C)) -> logits (B, H, W, n_classes)`` (or the last
    features ``(B, H, W, width)`` when ``n_classes`` is None)."""

    def __init__(self, cfg: LegacyUNetConfig):
        super().__init__()
        self.cfg = cfg
        w, factor = cfg.width, 2 if cfg.bilinear else 1
        dt = cfg.compute_dtype
        self.inc = DoubleConv(cfg.n_channels, w, compute_dtype=dt)
        self.down1 = Down(w, w * 2, dt)
        self.down2 = Down(w * 2, w * 4, dt)
        self.down3 = Down(w * 4, w * 8, dt)
        self.down4 = Down(w * 8, w * 16 // factor, dt)
        self.up1 = Up(w * 16, w * 8 // factor, cfg.bilinear, dt)
        self.up2 = Up(w * 8, w * 4 // factor, cfg.bilinear, dt)
        self.up3 = Up(w * 4, w * 2 // factor, cfg.bilinear, dt)
        self.up4 = Up(w * 2, w, cfg.bilinear, dt)
        if cfg.n_classes is not None:
            self.outc = OutConv(w, cfg.n_classes, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.cfg.compute_dtype).permute(0, 3, 1, 2)
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x = self.down4(x4)
        for up, skip in ((self.up1, x4), (self.up2, x3), (self.up3, x2), (self.up4, x1)):
            x = up(x, skip)
        if self.cfg.n_classes is not None:
            x = self.outc(x)
        return x.permute(0, 2, 3, 1)
