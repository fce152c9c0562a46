"""Volume evaluation for (multi-decoder) SAM (counterpart of
``mia_tpu/models/sam/validation.py``: ``test_single_volume`` and
``test_single_volume_mean``).

A volume becomes one batched slice-stack forward on the device: slices
resized to the patch size (antialiased bilinear), the decoders' softmaxes
ensembled, the argmax resized back (nearest-exact), then per-class (dice,
hd95) or spacing-aware (dice, hd, asd, jc) on the device
(``metrics.metric_percase_hd95`` / ``metric_percase``). NIfTI prediction
dumps use the dependency-free codec in ``utils/nifti.py``; prediction and
overlay PNGs follow the reference layout. The JAX package's depth buckets
and mesh padding are compile-cache and sharding devices, not ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ...metrics import metric_percase, metric_percase_hd95
from ...ops.resize import resize
from ...utils.common import draw_mask


def _as_decoder_list(masks):
    """Dual-mask models return a list of per-decoder tensors; plain ``Sam``
    one ``(D, H, W, C)`` tensor."""
    return masks if isinstance(masks, (list, tuple)) else [masks]


def _as_volume(image, label, device):
    image = torch.as_tensor(np.asarray(image, np.float32), device=device)
    label = torch.as_tensor(np.asarray(label, np.int32), device=device)
    if image.ndim == 5:
        image, label = image[0], label[0]
    return image, label


def _forward_volume(apply_fn, image_dhwc: torch.Tensor, patch_size):
    """Resize the slices, run the model once, ensemble the decoder softmaxes,
    nearest-resize the argmax back → ``(D, H, W)`` int32 and the outputs."""
    d, h, w, _ = image_dhwc.shape
    patch = (int(patch_size[0]), int(patch_size[1]))
    outputs = apply_fn(resize(image_dhwc, patch, "bilinear", antialias=True))
    masks = outputs["masks"] if isinstance(outputs, dict) else outputs
    ensemble = sum(m.to(torch.float32).softmax(-1) for m in _as_decoder_list(masks)
                   if m is not None)
    pred = ensemble.argmax(-1).to(torch.int32)
    if pred.shape[1:] != (h, w):
        pred = resize(pred[..., None], (h, w), "nearest_exact")[..., 0].to(torch.int32)
    return pred, outputs


def test_single_volume(image, label, apply_fn, classes: int, patch_size=(512, 512), loss_fn=None,
                       defer: bool = False, device=None):
    """image ``(1, D, H, W, C)`` or ``(D, H, W, C)``, label ``(…, D, H, W)``
    → (per-class (dice, hd95), loss). ``defer=True`` returns a ``(C-1, 2)``
    device tensor and a device scalar (no host sync); else a list of float
    pairs and a float."""
    image, label = _as_volume(image, label, device)
    with torch.no_grad():
        pred, outputs = _forward_volume(apply_fn, image, patch_size)
        loss = None
        if loss_fn is not None and isinstance(outputs, dict):
            patch = (int(patch_size[0]), int(patch_size[1]))
            resized_label = resize(label[..., None], patch, "nearest_exact")[..., 0].long()
            terms = [loss_fn(m, resized_label)[0] for m in _as_decoder_list(outputs["low_res_logits"])
                     if m is not None and tuple(m.shape[1:3]) == patch]
            if not terms:
                terms = [loss_fn(m, resized_label)[0] for m in _as_decoder_list(outputs["masks"])
                         if m is not None]
            if terms:
                loss = torch.stack(terms).mean()
        vals = (torch.stack([torch.stack(metric_percase_hd95(pred == i, label == i))
                             for i in range(1, classes)])
                if classes > 1 else torch.zeros((0, 2), device=pred.device))
    if defer:
        return vals, loss
    return [(float(d), float(h)) for d, h in vals.cpu().numpy()], (
        None if loss is None else float(loss))


def test_single_volume_mean(data_path, image, label, apply_fn, classes: int,
                            patch_size=(512, 512), test_save_path=None, case: str | None = None,
                            z_spacing: int = 1, raw_spacing=None, device=None):
    """Test-path evaluation: spacing-aware per-class (dice, hd, asd, jc) and,
    with ``test_save_path`` and ``case``, the prediction dumps."""
    image_t, label_t = _as_volume(image, label, device)
    with torch.no_grad():
        pred, _ = _forward_volume(apply_fn, image_t, patch_size)

    if raw_spacing is None and case is not None and data_path is not None:
        # the raw case's NIfTI spacing, reversed to (z, y, x)
        raw_case = Path(data_path) / "ACDC_raw" / f"{case}.nii.gz"
        if raw_case.is_file():
            from ...utils.nifti import read_nifti

            _, sp_xyz = read_nifti(raw_case)
            raw_spacing = sp_xyz[::-1]
    sp = tuple(float(s) for s in (raw_spacing if raw_spacing is not None else (1.0, 1.0, 1.0)))

    metric_list = []
    if classes > 1:
        vals = torch.stack([torch.stack(metric_percase(pred == i, label_t == i, sp))
                            for i in range(1, classes)]).cpu().numpy()
        metric_list = [tuple(float(x) for x in row) for row in vals]

    if test_save_path is not None and case is not None:
        from ...utils.nifti import write_nifti

        image_np = image_t.cpu().numpy()
        label_np = label_t.cpu().numpy()
        pred_np = pred.cpu().numpy()
        test_save_path = Path(test_save_path)
        test_save_path.mkdir(parents=True, exist_ok=True)
        write_nifti(test_save_path / f"{case}_pred.nii.gz", pred_np.astype(np.float32),
                    (1.0, 1.0, float(z_spacing)))
        label_path = test_save_path / str(case) / "label"
        visual_path = test_save_path / str(case) / "visual"
        label_path.mkdir(parents=True, exist_ok=True)
        visual_path.mkdir(parents=True, exist_ok=True)
        for i in range(pred_np.shape[0]):
            slice_img = (image_np[i][..., 0] * 255).astype(np.uint8)
            mask = pred_np[i].astype(np.uint8)
            Image.fromarray(mask).save(label_path / f"slice_{i}.png")
            visual = draw_mask(slice_img, label_np[i].astype(np.uint8), 0.2)
            visual = draw_mask(visual, mask, 0.4)
            Image.fromarray(visual).save(visual_path / f"slice_{i}.png")
    return metric_list
