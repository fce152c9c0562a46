"""2D UNet in PyTorch with the JAX package's semantics.

Counterpart of ``mia_tpu/models/unet.py`` in its default configuration:
plain blocks (conv → channel dropout → BatchNorm → LeakyReLU(0.01)),
stride-2 downsampling from level 1, ConvTranspose(k2, s2) upsampling with
(skip, upsampled) concatenation, 1×1 seg head.

- Parameter names are the reference PyTorch UNet's
  (``encoder.levels.{l}.{b}.all.{0,2}``, ``decoder.upsamples.{l}``,
  ``decoder.seg_output``), so reference ``.pth`` state dicts load as they are.
- The public layout is NHWC like the JAX package; inside, the input is
  permuted to NCHW, which for a contiguous NHWC tensor is a channels_last
  view with no copy.
- BatchNorm follows flax: the running variance is updated with the BIASED
  batch variance (``nn.BatchNorm2d`` would use the unbiased one), momentum
  0.9 in flax terms (0.1 in torch terms), eps 1e-5.
- Channel dropout draws from the caller's ``torch.Generator``.
- Initialisation follows flax's: lecun-normal (truncated) kernels, zero
  biases, unit BN scales.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    dimension: int = 2
    in_channels: int = 1
    out_classes: int = 4
    channels_list: tuple[int, ...] = (32, 64, 128, 256, 512)
    block_type: str = "plain"
    normalization: str = "batch"
    dropout_prob: float | None = 0.1
    deep_supervision: bool = False
    ds_layer: int = 0
    kernel_size: int = 3

    @property
    def num_levels(self) -> int:
        return len(self.channels_list)

    def check_ported(self) -> None:
        if (self.dimension, self.block_type, self.normalization) != (2, "plain", "batch"):
            raise NotImplementedError(
                "only the 2D UNet with plain blocks and batch norm is ported"
            )
        if self.deep_supervision:
            raise NotImplementedError("deep supervision is not ported")


def _lecun_normal_(weight: torch.Tensor, fan_in: int) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose running statistics update like flax's BatchNorm."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y


class ChannelDropout(nn.Module):
    """flax ``Dropout(broadcast_dims=spatial)``: zero whole channels with
    probability ``p`` and scale the kept ones by ``1 / (1 - p)``."""

    def __init__(self, p: float | None):
        super().__init__()
        self.p = float(p or 0.0)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        if not self.training or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        u = torch.rand(x.shape[:2] + (1, 1), generator=generator, device=x.device)
        return torch.where(u < keep_prob, x / keep_prob, torch.zeros((), device=x.device))


class PlainBlock(nn.Module):
    """conv → channel dropout → norm → LeakyReLU(0.01)."""

    def __init__(self, cfg: UNetConfig, cin: int, cout: int, stride: int):
        super().__init__()
        k = cfg.kernel_size
        conv = nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=True)
        _lecun_normal_(conv.weight, cin * k * k)
        nn.init.zeros_(conv.bias)
        self.all = nn.ModuleList(
            [conv, ChannelDropout(cfg.dropout_prob), FlaxBatchNorm2d(cout), nn.LeakyReLU(0.01)]
        )

    def forward(self, x, generator=None):
        conv, dropout, norm, act = self.all
        return act(norm(dropout(conv(x), generator)))


class UNetEncoder(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.levels = nn.ModuleList()
        prev = cfg.in_channels
        for level, c in enumerate(cfg.channels_list):
            stride = 1 if level == 0 else 2
            self.levels.append(
                nn.ModuleList([PlainBlock(cfg, prev, c, stride), PlainBlock(cfg, c, c, 1)])
            )
            prev = c

    def forward(self, x, generator=None):
        skips = []
        for blocks in self.levels:
            for block in blocks:
                x = block(x, generator)
            skips.append(x)
        return skips


class UNetDecoder(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        down = list(cfg.channels_list)[::-1]  # bottleneck first
        self.upsamples = nn.ModuleList()
        self.levels = nn.ModuleList()
        for l in range(len(down) - 1):
            cin, cout = down[l], down[l + 1]
            up = nn.ConvTranspose2d(cin, cout, 2, stride=2)
            # flax ConvTranspose kernel (2, 2, cin, cout): fan_in = 4 * cin
            _lecun_normal_(up.weight, 4 * cin)
            nn.init.zeros_(up.bias)
            self.upsamples.append(up)
            self.levels.append(
                nn.ModuleList([PlainBlock(cfg, 2 * cout, cout, 1), PlainBlock(cfg, cout, cout, 1)])
            )
        self.seg_output = nn.Conv2d(down[-1], cfg.out_classes, 1)
        _lecun_normal_(self.seg_output.weight, down[-1])
        nn.init.zeros_(self.seg_output.bias)

    def forward(self, skips, generator=None):
        x = skips[-1]
        for l, (up, blocks) in enumerate(zip(self.upsamples, self.levels)):
            x = torch.cat([skips[-(l + 2)], up(x)], dim=1)
            for block in blocks:
                x = block(x, generator)
        return self.seg_output(x)


class UNet(nn.Module):
    """``forward(x (B, H, W, C), generator=None) -> logits (B, H, W, K)``."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        self.encoder = UNetEncoder(cfg)
        self.decoder = UNetDecoder(cfg)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        logits = self.decoder(self.encoder(x, generator), generator)
        return logits.permute(0, 2, 3, 1)
