"""Device-side prompt self-generation for CPC-SAM (counterpart of
``mia_tpu/models/sam/prompt_generation.py::prompt_generate_random_fast``).

Batched over every mask at once: the pseudo-label of each of the ``N``
images is split into its ``C`` class masks, and the ``N·C`` masks go
through one connected-components call (K5, ``ops/morphology.py``) and one
batched 2D EDT (``ops/distance.py``). Random draws come from a device
``torch.Generator``: ``torch.multinomial`` over the tied maxima of the
distance map (centers) and over the largest component (random points),
``torch.rand`` for the box jitter, ``torch.randint`` for the per-class point
count. No host sync, no per-image Python loop. The draws cannot match the
JAX package's RNG; the distributions and every rule around them are its:

- every class gets ``num_points_prompt[1]`` point slots; slots beyond a
  per-class count drawn from ``[n0, n1]`` repeat the class's first point;
- a class absent from the pseudo-label falls back to class 0's first center
  (points and a degenerate box) and label 0;
- ``boxes_label`` is all zeros (reference-bug parity: box prompts always use
  the class-0 corner embeddings);
- the CC / EDT / bbox work runs at ``max_compute_size`` (nearest-downsampled
  pseudo-label) unless ``compute_at_native``, and coordinates are scaled
  back to the ``image_size`` frame.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ...ops.distance import squared_edt_2d
from ...ops.morphology import component_sizes_and_largest
from ...ops.resize import _nearest_index


def _nearest_resize(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest (asymmetric) resize of ``(N, H, W)`` by index gathers."""
    h, w = x.shape[-2:]
    ih = torch.from_numpy(_nearest_index(int(size[0]), h, False)).to(x.device, torch.long)
    iw = torch.from_numpy(_nearest_index(int(size[1]), w, False)).to(x.device, torch.long)
    return x.index_select(-2, ih).index_select(-1, iw)


def distance_to_zero(binary: torch.Tensor) -> torch.Tensor:
    """cv2.distanceTransform semantics on zero-padded masks ``(..., H, W)``
    (the JAX package's ``_distance_to_zero``, batched)."""
    fg = binary > 0
    padded = F.pad(fg, (1, 1, 1, 1))
    dist2 = squared_edt_2d(~padded)
    return torch.sqrt(dist2.clamp_min(0.0))[..., 1:-1, 1:-1] * fg


def _draw(weights: torch.Tensor, k: int, generator) -> torch.Tensor:
    """``k`` draws with replacement from each row of ``weights`` (M, P);
    an all-zero row draws uniformly (a categorical over equal logits)."""
    weights = torch.where(weights.sum(-1, keepdim=True) > 0, weights, torch.ones_like(weights))
    return torch.multinomial(weights, k, replacement=True, generator=generator)


def _jittered_bboxes(masks: torch.Tensor, rate: float, u: torch.Tensor) -> torch.Tensor:
    """Bounding boxes of ``masks`` (M, H, W) with random outward jitter of up
    to ``floor(extent · rate)`` per side, ``u`` (M, 4) uniform in [0, 1) →
    (M, 2, 2) ``((x1, y1), (x2, y2))`` float, clipped to the plane."""
    h, w = masks.shape[-2:]
    fg = masks > 0
    any_row, any_col = fg.any(-1), fg.any(-2)
    ys = torch.arange(h, device=masks.device, dtype=torch.float32)
    xs = torch.arange(w, device=masks.device, dtype=torch.float32)
    y1 = torch.where(any_row, ys, float(h)).amin(-1)
    y2 = torch.where(any_row, ys, -1.0).amax(-1)
    x1 = torch.where(any_col, xs, float(w)).amin(-1)
    x2 = torch.where(any_col, xs, -1.0).amax(-1)
    fx = torch.floor((x2 - x1) * rate)
    fy = torch.floor((y2 - y1) * rate)

    def randint(ui, lo, hi):  # [lo, hi) with per-row bounds, as the JAX package
        return torch.floor(lo + ui * (hi - lo))

    x1j = (x1 + randint(u[:, 0], -fx, 1.0)).clamp(0, w - 1)
    x2j = (x2 + randint(u[:, 1], 0.0, fx + 1.0)).clamp(0, w - 1)
    y1j = (y1 + randint(u[:, 2], -fy, 1.0)).clamp(0, h - 1)
    y2j = (y2 + randint(u[:, 3], 0.0, fy + 1.0)).clamp(0, h - 1)
    return torch.stack([torch.stack([x1j, y1j], -1), torch.stack([x2j, y2j], -1)], 1)


def prompt_generate_random_fast(
    coarse_probs: torch.Tensor,
    image_size: int,
    mask_input_size: Tuple[int, int],
    num_points_prompt: Tuple[int, int] = (1, 2),
    bbox_change_rate: Tuple[float, float] = (0.1, 0.2),
    israndom: bool = True,
    compute_at_native: bool = False,
    max_compute_size: int = 128,
    generator: torch.Generator | None = None,
):
    """coarse_probs ``(N, h, w, C)`` → prompts at ``image_size`` resolution.

    Returns ``(points, points_random, fit_boxes, loose_boxes, mask_prompt)``
    with points = (coords ``(N, C·P, 2)`` as (x, y), labels ``(N, C·P)``),
    boxes = (coords ``(N, C-1, 2, 2)``, labels ``(N, C-1)``) and
    mask_prompt ``(N, Hm, Wm, 1)``; ``israndom=False`` returns
    ``(points, fit_boxes, mask_prompt)``.
    """
    n_img, h, w, num_class = coarse_probs.shape
    device = coarse_probs.device
    max_pts = num_points_prompt[1]

    pred = coarse_probs.argmax(-1).to(torch.int32)
    compute = image_size if compute_at_native else min(h, image_size, max_compute_size)
    scale = image_size / compute
    if (h, w) != (compute, compute):
        pred = _nearest_resize(pred, (compute, compute))

    cls_ids = torch.arange(num_class, device=device, dtype=torch.int32)
    masks = (pred[:, None] == cls_ids[None, :, None, None]).to(torch.int32)  # (N, C, H, W)
    has_any = masks.flatten(2).any(-1)  # (N, C)
    # capped sweeps, as the JAX package: a fragment of an under-merged
    # component still lies inside the class mask
    _, _, largest = component_sizes_and_largest(masks, max_iters=16)
    dists = distance_to_zero(largest)  # (N, C, H, W)

    m = n_img * num_class
    flat_d = dists.reshape(m, -1)
    is_max = (flat_d >= flat_d.amax(-1, keepdim=True)).to(torch.float32)
    idx_c = _draw(is_max, max_pts, generator)  # (M, P)
    idx_r = _draw(largest.reshape(m, -1).to(torch.float32), max_pts, generator)
    cw = largest.shape[-1]

    def xy(idx):
        return torch.stack([idx % cw, idx // cw], -1).to(torch.float32).view(n_img, num_class,
                                                                              max_pts, 2)

    centers, randoms = xy(idx_c), xy(idx_r)
    counts = torch.randint(num_points_prompt[0], num_points_prompt[1] + 1, (n_img, num_class),
                           device=device, generator=generator)
    active = (torch.arange(max_pts, device=device) < counts[..., None])[..., None]
    centers = torch.where(active, centers, centers[:, :, :1])
    randoms = torch.where(active, randoms, randoms[:, :, :1])

    present = has_any[..., None, None]
    class0_first = centers[:, 0, 0][:, None, None]  # (N, 1, 1, 2)
    centers = torch.where(present, centers, class0_first)
    randoms = torch.where(present, randoms, class0_first)
    label_vals = torch.where(has_any & (cls_ids > 0), cls_ids, 0)
    labels = label_vals[..., None].expand(n_img, num_class, max_pts).reshape(n_img, -1)

    u = torch.rand((2, m, 4), device=device, generator=generator)
    flat_largest = largest.reshape(m, *largest.shape[-2:])
    fallback = class0_first.expand(n_img, num_class, 2, 2)
    fit = torch.where(present, _jittered_bboxes(flat_largest, bbox_change_rate[0], u[0])
                      .view(n_img, num_class, 2, 2), fallback)[:, 1:]
    loose = torch.where(present, _jittered_bboxes(flat_largest, bbox_change_rate[1], u[1])
                        .view(n_img, num_class, 2, 2), fallback)[:, 1:]

    points = centers.reshape(n_img, -1, 2)
    points_r = randoms.reshape(n_img, -1, 2)
    if scale != 1.0:
        # coarse pixel (x, y) covers fine pixels [x·s, x·s+s): points map to
        # the cell center, box corners to the cell's outer edges
        half = (scale - 1.0) * 0.5
        points = torch.floor(points * scale + half).clamp(0, image_size - 1)
        points_r = torch.floor(points_r * scale + half).clamp(0, image_size - 1)

        def scale_boxes(boxes):
            lo = boxes[:, :, 0] * scale
            hi = boxes[:, :, 1] * scale + (scale - 1.0)
            return torch.stack([lo, hi], 2).clamp(0, image_size - 1)

        fit, loose = scale_boxes(fit), scale_boxes(loose)

    box_labels = torch.zeros((n_img, num_class - 1), dtype=torch.int32, device=device)
    mask_prompt = _nearest_resize(pred.to(torch.float32), mask_input_size)[..., None]
    labels = labels.to(torch.int32)
    if israndom:
        return ((points, labels), (points_r, labels), (fit, box_labels), (loose, box_labels),
                mask_prompt)
    return (points, labels), (fit, box_labels), mask_prompt
