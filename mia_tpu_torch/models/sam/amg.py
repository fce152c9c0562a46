"""Automatic mask generation (counterpart of ``mia_tpu/models/sam/amg.py``):
``MaskData``, the uncompressed RLE codec, stability score, point grids,
batched mask → box, small-region removal, greedy box NMS and the
grid-prompted ``SamAutomaticMaskGenerator``.

The host helpers are numpy code, the port's own copy. The generator keeps
the JAX package's two phases: every chunk of grid points is dispatched back
to back with threshold, stability and IoU computed on the device and only
the two score vectors fetched; then only the survivors' masks are gathered
and copied to the host once. The JAX package bit-packs the thresholded
masks and fetches through ``fetch_async`` to spare its host link; here the
thresholded masks stay on the card as bool (64 × 3 × 512² = 50 MB a chunk)
and the survivors are copied back with one ``.cpu()``. PyTorch runs eagerly,
so there is no program cache keyed by shape, and the short final chunk is
decoded at its own length.
"""

from __future__ import annotations

from typing import Any, Generator, ItemsView, List

import numpy as np
import torch


class MaskData:
    """Dict-of-arrays container with filter and cat."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            assert isinstance(v, (list, np.ndarray)), "MaskData only supports list/ndarray"
        self._stats = dict(**kwargs)

    def __setitem__(self, key, item):
        self._stats[key] = item

    def __delitem__(self, key):
        del self._stats[key]

    def __getitem__(self, key):
        return self._stats[key]

    def items(self) -> ItemsView[str, Any]:
        return self._stats.items()

    def filter(self, keep: np.ndarray):
        for k, v in self._stats.items():
            if v is None:
                continue
            if isinstance(v, np.ndarray):
                self._stats[k] = v[keep]
            elif isinstance(v, list):
                idx = np.flatnonzero(keep) if keep.dtype == bool else keep
                self._stats[k] = [v[i] for i in idx]

    def cat(self, new_stats: "MaskData"):
        for k, v in new_stats.items():
            if k not in self._stats or self._stats[k] is None:
                self._stats[k] = v
            elif isinstance(v, np.ndarray):
                self._stats[k] = np.concatenate([self._stats[k], v], axis=0)
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + list(v)


def batch_iterator(batch_size: int, *args) -> Generator[List[Any], None, None]:
    assert len(args) > 0 and all(len(a) == len(args[0]) for a in args)
    n_batches = len(args[0]) // batch_size + int(len(args[0]) % batch_size != 0)
    for b in range(n_batches):
        yield [arg[b * batch_size: (b + 1) * batch_size] for arg in args]


def mask_to_rle(mask: np.ndarray) -> dict:
    """Uncompressed RLE, column-major like the upstream."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).transpose(1, 0).reshape(-1)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    idx = np.concatenate([[0], change, [len(flat)]])
    counts = [] if not flat[0] else [0]
    counts.extend(np.diff(idx).tolist())
    return {"size": [h, w], "counts": counts}


def rle_to_mask(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    mask = np.empty(h * w, dtype=bool)
    idx = 0
    parity = False
    for count in rle["counts"]:
        mask[idx: idx + count] = parity
        idx += count
        parity = not parity
    return mask.reshape(w, h).transpose()


def area_from_rle(rle: dict) -> int:
    return sum(rle["counts"][1::2])


def calculate_stability_score(masks: torch.Tensor, mask_threshold: float,
                              threshold_offset: float) -> torch.Tensor:
    """IoU of the high- and low-threshold binarisations of ``(..., H, W)``
    mask logits, on the logits' device."""
    masks = torch.as_tensor(masks)
    intersections = (masks > (mask_threshold + threshold_offset)).sum((-2, -1))
    unions = (masks > (mask_threshold - threshold_offset)).sum((-2, -1))
    return intersections / unions.clamp(min=1)


def build_point_grid(n_per_side: int) -> np.ndarray:
    offset = 1 / (2 * n_per_side)
    points_one_side = np.linspace(offset, 1 - offset, n_per_side)
    points_x = np.tile(points_one_side[None, :], (n_per_side, 1))
    points_y = np.tile(points_one_side[:, None], (1, n_per_side))
    return np.stack([points_x, points_y], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side, n_layers, scale_per_layer):
    return [
        build_point_grid(int(n_per_side / (scale_per_layer**i)))
        for i in range(n_layers + 1)
    ]


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """(…, H, W) bool → XYXY boxes; zeros for empty masks."""
    masks = np.asarray(masks, bool)
    shape = masks.shape
    h, w = shape[-2:]
    flat = masks.reshape(-1, h, w)
    rows = flat.any(axis=2)  # (N, H)
    cols = flat.any(axis=1)  # (N, W)
    top = rows.argmax(axis=1)
    bottom = h - 1 - rows[:, ::-1].argmax(axis=1)
    left = cols.argmax(axis=1)
    right = w - 1 - cols[:, ::-1].argmax(axis=1)
    boxes = np.stack([left, top, right, bottom], axis=1).astype(np.int64)
    boxes[~rows.any(axis=1)] = 0  # empty masks → zero box
    return boxes.reshape(*shape[:-2], 4)


def box_xyxy_to_xywh(box_xyxy: np.ndarray) -> np.ndarray:
    box = np.asarray(box_xyxy).copy()
    box[..., 2] = box[..., 2] - box[..., 0]
    box[..., 3] = box[..., 3] - box[..., 1]
    return box


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str):
    """Remove small islands or holes (8-connected, scipy)."""
    assert mode in ("holes", "islands")
    from scipy import ndimage

    correct_holes = mode == "holes"
    working = (correct_holes ^ mask).astype(np.uint8)
    labels, n = ndimage.label(working, structure=np.ones((3, 3)))
    sizes = ndimage.sum(working, labels, range(1, n + 1))
    small = [i + 1 for i, s in enumerate(sizes) if s < area_thresh]
    if not small:
        return mask, False
    fill = np.isin(labels, small)
    mask = mask.copy()
    mask[fill] = correct_holes
    return mask, True


def _box_nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS over XYXY boxes → kept indices."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        x1 = np.maximum(boxes[i, 0], boxes[:, 0])
        y1 = np.maximum(boxes[i, 1], boxes[:, 1])
        x2 = np.minimum(boxes[i, 2], boxes[:, 2])
        y2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        iou = inter / np.maximum(area_i + areas - inter, 1e-9)
        suppressed |= iou > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


class SamAutomaticMaskGenerator:
    """Grid-prompted AMG, single crop layer: point grid → batched decoder →
    IoU/stability filter → box NMS → records with RLE segmentation."""

    def __init__(
        self,
        predictor,
        points_per_side: int = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.88,
        stability_score_thresh: float = 0.95,
        stability_score_offset: float = 1.0,
        box_nms_thresh: float = 0.7,
        min_mask_region_area: int = 0,
    ):
        self.predictor = predictor
        self.point_grids = build_point_grid(points_per_side)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.min_mask_region_area = min_mask_region_area

    def chunk_prompts(self, batch_points: np.ndarray):
        """Grid points (original-image coordinates) → the ``(coords (n, P, 2),
        labels (n, P))`` point prompts of one chunk on the predictor's device,
        in input-image coordinates. An image must be set."""
        pred = self.predictor
        # one real point per prompt: exact_prompts predictors size tokens
        # like the reference; the default pads to max_points slots
        slots = 1 if getattr(pred, "exact_prompts", False) else max(pred.max_points, 1)
        pts = np.asarray(batch_points, np.float32)
        coords = np.zeros((len(pts), slots, 2), np.float32)
        labels = -np.ones((len(pts), slots), np.int32)
        coords[:, 0] = pred.transform.apply_coords(pts, pred.original_size)
        labels[:, 0] = 1
        return torch.from_numpy(coords).to(pred.device), torch.from_numpy(labels).to(pred.device)

    @torch.inference_mode()
    def score_chunk(self, batch_points: np.ndarray):
        """One chunk of grid points (original-image coordinates) through the
        prompt encoder and decoder, on the predictor's device: the
        thresholded masks ``(n, M, H, W)`` bool, the predicted iou ``(n, M)``
        and the stability score ``(n, M)``. An image must be set."""
        pred = self.predictor
        logits, iou, _ = pred.decode_on_device(points=self.chunk_prompts(batch_points))
        threshold = pred.model.mask_threshold
        stability = calculate_stability_score(logits, threshold, self.stability_score_offset)
        return logits > threshold, iou.float(), stability

    def generate(self, image: np.ndarray) -> list[dict]:
        self.predictor.set_image(image)
        h, w = image.shape[:2]
        points = self.point_grids * np.array([w, h])

        # phase 1: dispatch every chunk back to back (nothing waits for the
        # device); the thresholded masks stay there, only the two (n, M)
        # score vectors of each chunk are fetched, in one copy at the end
        chunk_masks, chunk_scores = [], []
        for (batch_points,) in batch_iterator(self.points_per_batch, points):
            masks_b, iou_b, stab_b = self.score_chunk(batch_points)
            chunk_masks.append(masks_b.flatten(0, 1))  # (n·M, H, W), point-major rows
            chunk_scores.append(torch.stack([iou_b, stab_b]))
        scores = torch.cat(chunk_scores, 1).cpu().numpy()  # (2, points, M)
        iou_all, stab_all = scores[0], scores[1]
        keep = (iou_all > self.pred_iou_thresh) & (stab_all > self.stability_score_thresh)
        # row-major flatten = the point-major order a per-point loop produces
        keep_flat = np.flatnonzero(keep.reshape(-1))
        if len(keep_flat) == 0:
            return []
        iou_preds = iou_all.reshape(-1)[keep_flat]

        # phase 2: gather only the survivors' masks, one copy to the host
        # (taken chunk by chunk, so the chunks are never copied into one tensor)
        survivors, first_row = [], 0
        for rows in chunk_masks:
            local = keep_flat[(keep_flat >= first_row) & (keep_flat < first_row + len(rows))]
            if len(local):
                survivors.append(rows[torch.from_numpy(local - first_row).to(rows.device)])
            first_row += len(rows)
        masks_keep = torch.cat(survivors).cpu().numpy()
        data = MaskData(masks=masks_keep, iou_preds=iou_preds)

        boxes = batched_mask_to_box(data["masks"])
        keep = _box_nms(boxes.astype(float), data["iou_preds"], self.box_nms_thresh)
        data.filter(keep)
        boxes = boxes[keep]

        records = []
        for i in range(len(data["masks"])):
            mask = data["masks"][i]
            if self.min_mask_region_area > 0:
                mask, _ = remove_small_regions(mask, self.min_mask_region_area, "islands")
                mask, _ = remove_small_regions(mask, self.min_mask_region_area, "holes")
            rle = mask_to_rle(mask)
            records.append(
                {
                    "segmentation": mask,
                    "rle": rle,
                    "area": int(mask.sum()),
                    "bbox": box_xyxy_to_xywh(boxes[i]).tolist(),
                    "predicted_iou": float(data["iou_preds"][i]),
                }
            )
        return records
