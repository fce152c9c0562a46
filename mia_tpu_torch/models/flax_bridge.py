"""Weight bridge between flax and torch: the inverse of
``mia_tpu/models/torch_port.py`` and of ``import_legacy_torch_checkpoint``
(``mia_tpu/models/legacy_unet.py``), and its own inverse.

``unet_state_dict_from_flax(variables)`` turns the JAX UNet's variables
(numpy arrays) into a state dict with the reference PyTorch parameter
names, loadable by :class:`mia_tpu_torch.models.UNet` and by the
reference's own UNet:

- Conv kernel HWIO → weight OIHW (DHWIO → OIDHW in 3D);
- ConvTranspose kernel ``(kh, kw, I, O)`` → weight ``(I, O, kh, kw)``
  (``(kd, kh, kw, I, O)`` → ``(I, O, kd, kh, kw)``), flipped on every
  spatial axis (``lax.conv_transpose`` correlates where torch's transposed
  convolution convolves);
- BatchNorm ``scale``/``bias`` + ``batch_stats`` ``mean``/``var`` →
  ``weight``/``bias``/``running_mean``/``running_var``; an instance norm has
  no ``batch_stats`` and no running statistics;
- residual blocks' ``skip_conv``/``skip_norm`` → ``downsample_skip.{0,1}``
  (their own norm sits at ``.all.1``), deep-supervision heads
  ``ds{l}_conv`` → ``decoder.ds.{l}.0``.

``legacy_unet_state_dict_from_flax(variables)`` does the same for the JAX
``LegacyUNet`` (``inc``, ``downs_{i}``, ``up_tconv{i}``, ``up_convs_{i}``,
``outc``) with the reference ``_UNet``'s names; a bilinear model has no
``up{i}.up`` entries.

``unet_state_dict_to_flax(sd)`` and ``legacy_unet_state_dict_to_flax(sd)``
go the other way, to the ``{"params", "batch_stats"}`` tree that the JAX
package writes to ``model.msgpack``: every transpose and tap flip undone,
BN running statistics copied as they are (``FlaxBatchNorm2d`` keeps flax's
biased variance), ``num_batches_tracked`` dropped. A state dict without
running statistics (an optimizer's moments) gives ``{"params"}`` alone.
Flax → torch → flax gives back every leaf bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _n(t: torch.Tensor) -> np.ndarray:
    """A C-order numpy copy (never a view of the tensor's memory)."""
    return np.array(t.detach().cpu().numpy(), order="C", copy=True)


def _norm_from_flax(sd: dict, prefix: str, params: Mapping, stats: Mapping | None) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    if stats is not None:
        sd[f"{prefix}.running_mean"] = _t(stats["mean"])
        sd[f"{prefix}.running_var"] = _t(stats["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv_weight(kernel) -> torch.Tensor:
    """Flax kernel ``(*spatial, I, O)`` → torch weight ``(O, I, *spatial)``."""
    kernel = np.asarray(kernel)
    nd = kernel.ndim - 2
    return _t(kernel.transpose(nd + 1, nd, *range(nd)))


def _tconv_weight(kernel) -> torch.Tensor:
    """Flax ConvTranspose kernel ``(*spatial, I, O)`` → torch weight
    ``(I, O, *spatial)``, every spatial axis flipped."""
    kernel = np.asarray(kernel)
    nd = kernel.ndim - 2
    return _t(kernel[(slice(None, None, -1),) * nd].transpose(nd, nd + 1, *range(nd)))


def _conv_from_flax(sd: dict, prefix: str, params: Mapping) -> None:
    sd[f"{prefix}.weight"] = _conv_weight(params["kernel"])
    sd[f"{prefix}.bias"] = _t(params["bias"])


def _block(sd: dict, prefix: str, params: Mapping, stats: Mapping | None, res: bool) -> None:
    """A plain block (norm at ``.all.2``) or a residual one (norm at
    ``.all.1``, skip at ``.downsample_skip.{0,1}``)."""
    _conv_from_flax(sd, f"{prefix}.all.0", params["conv"])
    _norm_from_flax(sd, f"{prefix}.all.{1 if res else 2}", params["norm"],
                    stats["norm"] if stats else None)
    if "skip_conv" in params:
        _conv_from_flax(sd, f"{prefix}.downsample_skip.0", params["skip_conv"])
        _norm_from_flax(sd, f"{prefix}.downsample_skip.1", params["skip_norm"],
                        stats["skip_norm"] if stats else None)


def unet_state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax UNet ``{"params"[, "batch_stats"]}`` → reference-named state dict.

    Plain or residual blocks (a UNet with any ``skip_conv`` is residual),
    batch norm (with ``batch_stats``) or instance norm (without), and the
    deep-supervision heads ``ds{l}_conv`` → ``decoder.ds.{l}.0``."""
    params = variables["params"]
    stats = variables.get("batch_stats") or None
    enc, dec = params["encoder"], params["decoder"]
    num_levels = sum(1 for k in enc if k.endswith("_block0"))
    res = any("skip_conv" in block for scope in (enc, dec) for block in scope.values())

    sd: dict[str, torch.Tensor] = {}
    for level in range(num_levels):
        for b in range(2):
            name = f"level{level}_block{b}"
            _block(sd, f"encoder.levels.{level}.{b}", enc[name],
                   stats["encoder"][name] if stats else None, res)
    for l in range(num_levels - 1):
        sd[f"decoder.upsamples.{l}.weight"] = _tconv_weight(dec[f"up{l}"]["kernel"])
        sd[f"decoder.upsamples.{l}.bias"] = _t(dec[f"up{l}"]["bias"])
        for b in range(2):
            name = f"level{l}_block{b}"
            _block(sd, f"decoder.levels.{l}.{b}", dec[name],
                   stats["decoder"][name] if stats else None, res)
        if f"ds{l}_conv" in dec:
            _conv_from_flax(sd, f"decoder.ds.{l}.0", dec[f"ds{l}_conv"])
    _conv_from_flax(sd, "decoder.seg_output", dec["seg_output"])
    return sd


def _double_conv(sd: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    for i, (ci, ni) in enumerate(((0, 1), (3, 4))):
        sd[f"{prefix}.{ci}.weight"] = _conv_weight(params[f"conv{i}"]["kernel"])
        sd[f"{prefix}.{ni}.weight"] = _t(params[f"norm{i}"]["scale"])
        sd[f"{prefix}.{ni}.bias"] = _t(params[f"norm{i}"]["bias"])
        sd[f"{prefix}.{ni}.running_mean"] = _t(stats[f"norm{i}"]["mean"])
        sd[f"{prefix}.{ni}.running_var"] = _t(stats[f"norm{i}"]["var"])
        sd[f"{prefix}.{ni}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def legacy_unet_state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax LegacyUNet ``{"params", "batch_stats"}`` → a state dict with the
    reference ``_UNet``'s names, loadable by :class:`mia_tpu_torch.models.LegacyUNet`."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    _double_conv(sd, "inc.double_conv", params["inc"], stats["inc"])
    for i in range(4):
        _double_conv(sd, f"down{i + 1}.maxpool_conv.1.double_conv", params[f"downs_{i}"],
                     stats[f"downs_{i}"])
        if f"up_tconv{i}" in params:
            sd[f"up{i + 1}.up.weight"] = _tconv_weight(params[f"up_tconv{i}"]["kernel"])
            sd[f"up{i + 1}.up.bias"] = _t(params[f"up_tconv{i}"]["bias"])
        _double_conv(sd, f"up{i + 1}.conv.double_conv", params[f"up_convs_{i}"],
                     stats[f"up_convs_{i}"])
    if "outc" in params:
        sd["outc.conv.weight"] = _conv_weight(params["outc"]["kernel"])
        sd["outc.conv.bias"] = _t(params["outc"]["bias"])
    return sd


# --- torch → flax -----------------------------------------------------------------


def _conv_kernel(w: torch.Tensor) -> np.ndarray:
    """OIHW (OIDHW) weight → HWIO (DHWIO) kernel."""
    return _n(w.permute(*range(2, w.ndim), 1, 0))


def _tconv_kernel(w: torch.Tensor) -> np.ndarray:
    """Transposed-conv weight ``(I, O, *spatial)`` → flax kernel
    ``(*spatial, I, O)``, taps flipped back."""
    return _n(w.permute(*range(2, w.ndim), 0, 1).flip(tuple(range(w.ndim - 2))))


def _tree(params: dict, stats: dict) -> dict:
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def _conv_to_flax(sd: Mapping, prefix: str) -> dict:
    return {"kernel": _conv_kernel(sd[f"{prefix}.weight"]), "bias": _n(sd[f"{prefix}.bias"])}


def _norm_to_flax(sd: Mapping, prefix: str, params: dict, stats: dict, name: str) -> None:
    params[name] = {"scale": _n(sd[f"{prefix}.weight"]), "bias": _n(sd[f"{prefix}.bias"])}
    if f"{prefix}.running_mean" in sd:
        stats[name] = {"mean": _n(sd[f"{prefix}.running_mean"]),
                       "var": _n(sd[f"{prefix}.running_var"])}


def _block_to_flax(sd: Mapping, prefix: str, params: dict, stats: dict, name: str,
                   res: bool) -> None:
    block, block_stats = {"conv": _conv_to_flax(sd, f"{prefix}.all.0")}, {}
    _norm_to_flax(sd, f"{prefix}.all.{1 if res else 2}", block, block_stats, "norm")
    if f"{prefix}.downsample_skip.0.weight" in sd:
        block["skip_conv"] = _conv_to_flax(sd, f"{prefix}.downsample_skip.0")
        _norm_to_flax(sd, f"{prefix}.downsample_skip.1", block, block_stats, "skip_norm")
    params[name] = block
    if block_stats:
        stats[name] = block_stats


def unet_state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> dict:
    """Reference-named UNet state dict → flax ``{"params"[, "batch_stats"]}``:
    plain or residual blocks (norm at ``.all.1``), batch or instance norm
    (no running statistics, no ``batch_stats``), deep-supervision heads."""
    num_levels = sum(1 for k in sd
                     if k.startswith("encoder.levels.") and k.endswith(".0.all.0.weight"))
    res = "encoder.levels.0.0.all.1.weight" in sd
    enc, dec, enc_stats, dec_stats = {}, {}, {}, {}
    for level in range(num_levels):
        for b in range(2):
            _block_to_flax(sd, f"encoder.levels.{level}.{b}", enc, enc_stats,
                           f"level{level}_block{b}", res)
    for l in range(num_levels - 1):
        dec[f"up{l}"] = {"kernel": _tconv_kernel(sd[f"decoder.upsamples.{l}.weight"]),
                         "bias": _n(sd[f"decoder.upsamples.{l}.bias"])}
        for b in range(2):
            _block_to_flax(sd, f"decoder.levels.{l}.{b}", dec, dec_stats, f"level{l}_block{b}",
                           res)
        if f"decoder.ds.{l}.0.weight" in sd:
            dec[f"ds{l}_conv"] = _conv_to_flax(sd, f"decoder.ds.{l}.0")
    dec["seg_output"] = _conv_to_flax(sd, "decoder.seg_output")
    stats = {"encoder": enc_stats, "decoder": dec_stats} if enc_stats else {}
    return _tree({"encoder": enc, "decoder": dec}, stats)


def _double_conv_to_flax(sd: Mapping, prefix: str, params: dict, stats: dict, name: str) -> None:
    params[name], block_stats = {}, {}
    for i, (ci, ni) in enumerate(((0, 1), (3, 4))):
        params[name][f"conv{i}"] = {"kernel": _conv_kernel(sd[f"{prefix}.{ci}.weight"])}
        params[name][f"norm{i}"] = {"scale": _n(sd[f"{prefix}.{ni}.weight"]),
                                    "bias": _n(sd[f"{prefix}.{ni}.bias"])}
        if f"{prefix}.{ni}.running_mean" in sd:
            block_stats[f"norm{i}"] = {"mean": _n(sd[f"{prefix}.{ni}.running_mean"]),
                                       "var": _n(sd[f"{prefix}.{ni}.running_var"])}
    if block_stats:
        stats[name] = block_stats


def legacy_unet_state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> dict:
    """Reference ``_UNet`` state dict → flax LegacyUNet ``{"params", "batch_stats"}``."""
    params, stats = {}, {}
    _double_conv_to_flax(sd, "inc.double_conv", params, stats, "inc")
    for i in range(4):
        _double_conv_to_flax(sd, f"down{i + 1}.maxpool_conv.1.double_conv", params, stats,
                             f"downs_{i}")
        if f"up{i + 1}.up.weight" in sd:
            params[f"up_tconv{i}"] = {"kernel": _tconv_kernel(sd[f"up{i + 1}.up.weight"]),
                                      "bias": _n(sd[f"up{i + 1}.up.bias"])}
        _double_conv_to_flax(sd, f"up{i + 1}.conv.double_conv", params, stats, f"up_convs_{i}")
    if "outc.conv.weight" in sd:
        params["outc"] = {"kernel": _conv_kernel(sd["outc.conv.weight"]),
                          "bias": _n(sd["outc.conv.bias"])}
    return _tree(params, stats)
