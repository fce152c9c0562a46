"""Weight bridge flax → torch: the inverse of ``mia_tpu/models/torch_port.py``
and of ``import_legacy_torch_checkpoint`` (``mia_tpu/models/legacy_unet.py``).

``unet_state_dict_from_flax(variables)`` turns the JAX UNet's variables
(numpy arrays) into a state dict with the reference PyTorch parameter
names, loadable by :class:`mia_tpu_torch.models.UNet` and by the
reference's own UNet:

- Conv kernel HWIO → weight OIHW;
- ConvTranspose kernel ``(kh, kw, I, O)`` → weight ``(I, O, kh, kw)``,
  spatially flipped (``lax.conv_transpose`` correlates where torch's
  transposed convolution convolves);
- BatchNorm ``scale``/``bias`` + ``batch_stats`` ``mean``/``var`` →
  ``weight``/``bias``/``running_mean``/``running_var``.

``legacy_unet_state_dict_from_flax(variables)`` does the same for the JAX
``LegacyUNet`` (``inc``, ``downs_{i}``, ``up_tconv{i}``, ``up_convs_{i}``,
``outc``) with the reference ``_UNet``'s names; a bilinear model has no
``up{i}.up`` entries.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _block(sd: dict, prefix: str, params: Mapping, stats: Mapping | None) -> None:
    sd[f"{prefix}.all.0.weight"] = _t(np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{prefix}.all.0.bias"] = _t(params["conv"]["bias"])
    sd[f"{prefix}.all.2.weight"] = _t(params["norm"]["scale"])
    sd[f"{prefix}.all.2.bias"] = _t(params["norm"]["bias"])
    if stats is not None:
        sd[f"{prefix}.all.2.running_mean"] = _t(stats["norm"]["mean"])
        sd[f"{prefix}.all.2.running_var"] = _t(stats["norm"]["var"])
        sd[f"{prefix}.all.2.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def unet_state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax UNet ``{"params", "batch_stats"}`` → reference-named state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats") or None
    enc, dec = params["encoder"], params["decoder"]
    num_levels = sum(1 for k in enc if k.endswith("_block0"))

    sd: dict[str, torch.Tensor] = {}
    for level in range(num_levels):
        for b in range(2):
            name = f"level{level}_block{b}"
            _block(sd, f"encoder.levels.{level}.{b}", enc[name],
                   stats["encoder"][name] if stats else None)
    for l in range(num_levels - 1):
        kernel = np.asarray(dec[f"up{l}"]["kernel"])[::-1, ::-1]
        sd[f"decoder.upsamples.{l}.weight"] = _t(kernel.transpose(2, 3, 0, 1))
        sd[f"decoder.upsamples.{l}.bias"] = _t(dec[f"up{l}"]["bias"])
        for b in range(2):
            name = f"level{l}_block{b}"
            _block(sd, f"decoder.levels.{l}.{b}", dec[name],
                   stats["decoder"][name] if stats else None)
    sd["decoder.seg_output.weight"] = _t(np.asarray(dec["seg_output"]["kernel"]).transpose(3, 2, 0, 1))
    sd["decoder.seg_output.bias"] = _t(dec["seg_output"]["bias"])
    return sd


def _double_conv(sd: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    for i, (ci, ni) in enumerate(((0, 1), (3, 4))):
        kernel = np.asarray(params[f"conv{i}"]["kernel"])
        sd[f"{prefix}.{ci}.weight"] = _t(kernel.transpose(3, 2, 0, 1))
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
            kernel = np.asarray(params[f"up_tconv{i}"]["kernel"])[::-1, ::-1]
            sd[f"up{i + 1}.up.weight"] = _t(kernel.transpose(2, 3, 0, 1))
            sd[f"up{i + 1}.up.bias"] = _t(params[f"up_tconv{i}"]["bias"])
        _double_conv(sd, f"up{i + 1}.conv.double_conv", params[f"up_convs_{i}"],
                     stats[f"up_convs_{i}"])
    if "outc" in params:
        sd["outc.conv.weight"] = _t(np.asarray(params["outc"]["kernel"]).transpose(3, 2, 0, 1))
        sd["outc.conv.bias"] = _t(params["outc"]["bias"])
    return sd
