"""2D and 3D UNet in PyTorch with the JAX package's semantics.

Counterpart of ``mia_tpu/models/unet.py``: two blocks a level, stride-2
downsampling from level 1, ConvTranspose(k2, s2) upsampling with
(skip, upsampled) concatenation, 1×1 seg head. ``einsum_upsample=True``
builds the decoder's upsampling as :class:`EinsumConvTranspose2x` (one GEMM,
or, in 2D, kernel K10 with ``use_kernel="always"``) instead of
``nn.ConvTranspose{2,3}d``; both carry the same parameters.
``dimension=3`` builds the same network of ``Conv3d``, ``ConvTranspose3d``
and 3D norms over ``(D, H, W)``; no hand kernel lies on that path.

- Blocks: ``plain`` (conv → channel dropout → norm → LeakyReLU(0.01)) or
  ``res`` (conv → norm → channel dropout → LeakyReLU, plus a 1×1 conv + norm
  skip when the channels or the stride change, added after the activation).
- Norms: ``batch`` (below) or ``instance`` (``nn.InstanceNorm{2,3}d``: affine,
  biased variance, eps 1e-5, instance statistics in training and in eval,
  no running statistics — the JAX package's ``InstanceNorm``).
- ``deep_supervision`` with ``ds_layer > 1`` builds 1×1 heads ``ds{l}`` on the
  decoder levels ``range(num_upsample - ds_layer, num_upsample - 1)``; they
  always exist (their parameters are in every checkpoint) and only
  ``return_ds=True`` runs them, each resized to the logits' size:
  bilinearly without antialiasing in 2D, trilinearly over (D, H, W) in 3D
  (``F.interpolate``, ``align_corners=False``). The JAX package's 3D heads
  go through its 2D resize, which scales H and W only and leaves D and W at
  the head's size, so they come out smaller than the logits; the port's
  3D heads have the logits' shape, a documented deviation.
- Parameter names are the reference PyTorch UNet's
  (``encoder.levels.{l}.{b}.all.{0,2}`` for plain blocks, ``.all.{0,1}`` and
  ``.downsample_skip.{0,1}`` for residual ones, ``decoder.upsamples.{l}``,
  ``decoder.ds.{l}.0``, ``decoder.seg_output``), so reference ``.pth`` state
  dicts load as they are.
- The public layout is NHWC (NDHWC in 3D) like the JAX package; inside,
  the input is permuted to NCHW (NCDHW), which for a contiguous channel-last
  tensor is a channels_last (channels_last_3d) view with no copy.
- BatchNorm follows flax: the running variance is updated with the BIASED
  batch variance (``nn.BatchNorm2d`` would use the unbiased one), momentum
  0.9 in flax terms (0.1 in torch terms), eps 1e-5.
- Channel dropout draws from the caller's ``torch.Generator``.
- Initialisation follows flax's: lecun-normal (truncated) kernels, zero
  biases, unit norm scales.
- ``compute_dtype=torch.bfloat16`` is flax's ``dtype=`` on every layer:
  parameters stay float32 and are cast to bfloat16 at each call (flax's
  ``promote_dtype``), the input is cast at the model's entry, convolutions,
  dropout, activations and the skip concatenation run in bfloat16, and the
  norms compute their statistics and affine in float32 and hand back
  bfloat16 (the running statistics stay float32). The logits come out in
  bfloat16; the losses and the softmax take them to float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, Conv3d, ConvTranspose2d, ConvTranspose3d

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
    # the activations' dtype (float32 or bfloat16); parameters stay float32
    compute_dtype: torch.dtype = torch.float32
    # decoder upsampling through EinsumConvTranspose2x instead of
    # nn.ConvTranspose{2,3}d (the JAX package's flag of the same name)
    einsum_upsample: bool = False

    @property
    def num_levels(self) -> int:
        return len(self.channels_list)

    @property
    def ds_levels(self) -> list[int]:
        """Decoder levels that carry a deep-supervision head."""
        if not (self.deep_supervision and self.ds_layer > 1):
            return []
        n_up = self.num_levels - 1
        return list(range(n_up - self.ds_layer, n_up - 1))

    def check_ported(self) -> None:
        if self.dimension not in (2, 3):
            raise ValueError(f"dimension must be 2 or 3, got {self.dimension}")
        if self.block_type not in ("plain", "res"):
            raise ValueError(f"unknown block type: {self.block_type}")
        if self.normalization not in ("batch", "instance"):
            raise ValueError(f"unknown normalization: {self.normalization}")
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {self.compute_dtype}")


def _lecun_normal_(weight: torch.Tensor, fan_in: int) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


class _FlaxBatchNorm:
    """Running statistics updated like flax's BatchNorm: the biased batch
    variance, over every axis but the channels. Statistics and affine in
    float32; the output takes the input's dtype (flax's ``dtype=``)."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if not self.training:
            return F.batch_norm(
                x32, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            ).to(x.dtype)
        y = F.batch_norm(x32, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x32, dim=(0, *range(2, x.ndim)), correction=0)
            self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


class FlaxBatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """BatchNorm2d whose running statistics update like flax's BatchNorm."""


class FlaxBatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """BatchNorm3d whose running statistics update like flax's BatchNorm."""


class _Float32Norm:
    """Statistics and affine in float32, the output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


class InstanceNorm2d(_Float32Norm, nn.InstanceNorm2d):
    pass


class InstanceNorm3d(_Float32Norm, nn.InstanceNorm3d):
    pass


def _norm(cfg: UNetConfig, features: int) -> nn.Module:
    if cfg.normalization == "instance":
        norm = InstanceNorm3d if cfg.dimension == 3 else InstanceNorm2d
        return norm(features, eps=1e-5, affine=True, track_running_stats=False)
    return FlaxBatchNorm3d(features) if cfg.dimension == 3 else FlaxBatchNorm2d(features)


def _conv(cin: int, cout: int, k: int, stride: int = 1, dimension: int = 2,
          compute_dtype: torch.dtype = torch.float32) -> nn.Module:
    """Conv with flax's initialisation (lecun-normal kernel, zero bias)."""
    conv = (Conv3d if dimension == 3 else Conv2d)(
        cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=True, compute_dtype=compute_dtype)
    _lecun_normal_(conv.weight, cin * k ** dimension)
    nn.init.zeros_(conv.bias)
    return conv


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """NC... → N...C (a view)."""
    return x.permute(0, *range(2, x.ndim), 1)


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    """N...C → NC... (a view)."""
    return x.permute(0, x.ndim - 1, *range(1, x.ndim - 1))


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
        u = torch.rand(x.shape[:2] + (1,) * (x.ndim - 2), generator=generator, device=x.device)
        return torch.where(u < keep_prob, x / keep_prob, torch.zeros((), device=x.device))


class PlainBlock(nn.Module):
    """conv → channel dropout → norm → LeakyReLU(0.01)."""

    def __init__(self, cfg: UNetConfig, cin: int, cout: int, stride: int):
        super().__init__()
        self.all = nn.ModuleList([
            _conv(cin, cout, cfg.kernel_size, stride, cfg.dimension, cfg.compute_dtype),
            ChannelDropout(cfg.dropout_prob),
            _norm(cfg, cout), nn.LeakyReLU(0.01),
        ])

    def forward(self, x, generator=None):
        conv, dropout, norm, act = self.all
        return act(norm(dropout(conv(x), generator)))


class ResidualBlock(nn.Module):
    """conv → norm → channel dropout → LeakyReLU(0.01), plus the input, or a
    1×1 conv + norm of it when the channels or the stride change, added
    after the activation."""

    def __init__(self, cfg: UNetConfig, cin: int, cout: int, stride: int):
        super().__init__()
        self.all = nn.ModuleList([
            _conv(cin, cout, cfg.kernel_size, stride, cfg.dimension, cfg.compute_dtype),
            _norm(cfg, cout), ChannelDropout(cfg.dropout_prob), nn.LeakyReLU(0.01),
        ])
        self.stride = stride
        self.downsample_skip = (
            nn.Sequential(_conv(cin, cout, 1, stride, cfg.dimension, cfg.compute_dtype),
                          _norm(cfg, cout))
            if cin != cout or stride != 1 else None
        )

    def forward(self, x, generator=None):
        conv, norm, dropout, act = self.all
        out = act(dropout(norm(conv(x)), generator))
        if self.downsample_skip is None:
            return x + out
        if x.device.type == "cpu" and self.stride != 1 and x.ndim == 4:
            # PyTorch's CPU backward of a strided 1x1 conv on a channels_last
            # input corrupts the heap (torch 2.13; its 3D counterpart ran
            # clean): the same conv at stride 1 on every s-th pixel, the same
            # parameters and sums
            skip_conv, skip_norm = self.downsample_skip
            s = self.stride
            return skip_norm(skip_conv._compute(F.conv2d, x[:, :, ::s, ::s])) + out
        return self.downsample_skip(x) + out


def _block(cfg: UNetConfig):
    return {"plain": PlainBlock, "res": ResidualBlock}[cfg.block_type]


class EinsumConvTranspose2x(nn.Module):
    """Drop-in for ``nn.ConvTranspose{2,3}d(cin, cout, 2, stride=2)`` on
    channel-last input: ``(B, H, W, Cin)`` → ``(B, 2H, 2W, Cout)`` (or the 3D
    counterpart), with that module's parameter names, shapes
    (``weight (Cin, Cout, 2, 2[, 2])``, ``bias``) and initialisation, so its
    state dicts load as they are.

    A k2/s2 transposed convolution gives every output pixel one tap,
    ``y[2i+di, 2j+dj] = x[i, j] · W[:, :, di, dj] + b`` (torch's weight is in
    output order; flax's kernel is the reverse), so the whole layer is one
    GEMM plus an interleave. ``use_kernel="never"`` (the default, the JAX
    module's ``use_pallas``) runs that plain form; ``"always"`` (2D only)
    goes through :func:`mia_tpu_torch.ops.upsample2x.conv_transpose2x`: kernel
    K10 and its backward K10b on a CUDA tensor, the plain form on a CPU one.
    ``compute_dtype`` is flax's ``dtype=``: x, weight and bias are cast to it.
    In bfloat16 the two options round as the JAX module's do: ``"never"``
    as its einsum (a bfloat16 product, then the bfloat16 bias added),
    ``"always"`` as its Pallas kernel, which takes the bias as float32 (the
    bfloat16 rounding carried as float32), sums in float32 and rounds once;
    so on the CPU ``"always"`` matches JAX's ``use_pallas="always"``, not
    its ``"never"``.
    """

    def __init__(self, in_channels: int, out_channels: int, dimension: int = 2,
                 use_kernel: str = "never", compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        if dimension not in (2, 3):
            raise ValueError(f"dimension must be 2 or 3, got {dimension}")
        if use_kernel not in ("never", "always"):
            raise ValueError(f'use_kernel must be "never" or "always", got {use_kernel!r}')
        self.in_channels, self.out_channels = in_channels, out_channels
        self.dimension, self.use_kernel = dimension, use_kernel
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, *(2,) * dimension))
        self.bias = nn.Parameter(torch.empty(out_channels))
        # nn.ConvTranspose2d's own initialisation, draw for draw
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        bound = 1.0 / math.sqrt(out_channels * 2 ** dimension)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.upsample2x import conv_transpose2x, conv_transpose2x_plain

        dt = self.compute_dtype  # flax's promote_dtype: x, weight and bias in the compute dtype
        x, weight, bias = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        if self.dimension == 2:
            w = weight.permute(2, 3, 0, 1)  # (di, dj, Cin, Cout)
            if self.use_kernel == "always":  # K10 takes the bias as float32, as the Pallas call
                return conv_transpose2x(x, w, bias.to(torch.float32))
            return conv_transpose2x_plain(x, w, bias)
        b, d, h, ww, _ = x.shape
        y = torch.einsum("bdhwc,cfijk->bdihjwkf", x, weight)
        return y.reshape(b, 2 * d, 2 * h, 2 * ww, self.out_channels) + bias

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels}, dimension={self.dimension}, "
                f"use_kernel={self.use_kernel!r}")


class UNetEncoder(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        block = _block(cfg)
        self.levels = nn.ModuleList()
        prev = cfg.in_channels
        for level, c in enumerate(cfg.channels_list):
            stride = 1 if level == 0 else 2
            self.levels.append(nn.ModuleList([block(cfg, prev, c, stride), block(cfg, c, c, 1)]))
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
        block = _block(cfg)
        down = list(cfg.channels_list)[::-1]  # bottleneck first
        self.down = down
        self.upsamples = nn.ModuleList()
        self.levels = nn.ModuleList()
        self.dimension = cfg.dimension
        transpose = ConvTranspose3d if cfg.dimension == 3 else ConvTranspose2d
        for l in range(len(down) - 1):
            cin, cout = down[l], down[l + 1]
            up = (EinsumConvTranspose2x(cin, cout, cfg.dimension,
                                        compute_dtype=cfg.compute_dtype) if cfg.einsum_upsample
                  else transpose(cin, cout, 2, stride=2, compute_dtype=cfg.compute_dtype))
            # flax ConvTranspose kernel (2, .., 2, cin, cout): fan_in = 2**nd * cin
            _lecun_normal_(up.weight, 2 ** cfg.dimension * cin)
            nn.init.zeros_(up.bias)
            self.upsamples.append(up)
            self.levels.append(
                nn.ModuleList([block(cfg, 2 * cout, cout, 1), block(cfg, cout, cout, 1)])
            )
        # deep-supervision heads, keyed by decoder level (``decoder.ds.{l}.0``)
        self.ds = nn.ModuleDict({
            str(l): nn.Sequential(_conv(down[l + 1], cfg.out_classes, 1, 1, cfg.dimension,
                                        cfg.compute_dtype))
            for l in cfg.ds_levels
        })
        self.seg_output = _conv(down[-1], cfg.out_classes, 1, 1, cfg.dimension,
                                cfg.compute_dtype)

    def forward(self, skips, generator=None, return_feature: bool = False,
                return_ds: bool = False):
        from ..ops.resize import resize

        x = skips[-1]
        ds_outputs = []
        for l, (up, blocks) in enumerate(zip(self.upsamples, self.levels)):
            if isinstance(up, EinsumConvTranspose2x):  # channel-last in and out: views
                x = _channels_first(up(_channels_last(x)))
            else:
                x = up(x)
            x = torch.cat([skips[-(l + 2)], x], dim=1)
            for block in blocks:
                x = block(x, generator)
            if return_ds and str(l) in self.ds:
                ds = self.ds[str(l)](x)
                factor = self.down[l + 1] // self.down[-1]
                if self.dimension == 3:
                    ds = F.interpolate(ds, scale_factor=factor, mode="trilinear",
                                       align_corners=False)
                else:
                    ds = _channels_last(ds)
                    ds = _channels_first(resize(
                        ds, (ds.shape[1] * factor, ds.shape[2] * factor), "bilinear",
                        antialias=False))
                ds_outputs.append(ds)
        logits = self.seg_output(x)
        if return_ds:
            return [logits] + ds_outputs[::-1]
        if return_feature:
            return logits, x
        return logits


class UNet(nn.Module):
    """``forward(x (B, H, W, C), generator=None) -> logits (B, H, W, K)``
    (``(B, D, H, W, C)`` → ``(B, D, H, W, K)`` in 3D); with
    ``return_ds=True``, ``[logits, ds heads from the finest level down]``,
    each of the logits' shape.

    Feature endpoints of the AL selectors: ``enc_feature`` (the bottleneck
    averaged over space, ``(B, C)``) and ``pixel_feature`` (the logits and the
    decoder's features before the seg head, both channel-last).
    """

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        self.encoder = UNetEncoder(cfg)
        self.decoder = UNetDecoder(cfg)

    def _skips(self, x: torch.Tensor, generator):
        return self.encoder(_channels_first(x.to(self.cfg.compute_dtype)), generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                return_ds: bool = False):
        out = self.decoder(self._skips(x, generator), generator, return_ds=return_ds)
        if return_ds:
            return [_channels_last(o) for o in out]
        return _channels_last(out)

    def enc_feature(self, x: torch.Tensor, generator: torch.Generator | None = None):
        bottleneck = self._skips(x, generator)[-1]
        return bottleneck.mean(tuple(range(2, bottleneck.ndim)))

    def pixel_feature(self, x: torch.Tensor, generator: torch.Generator | None = None):
        logits, feature = self.decoder(self._skips(x, generator), generator, return_feature=True)
        return _channels_last(logits), _channels_last(feature)
