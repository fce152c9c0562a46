"""Mathematical morphology and connected components of masks — kernel K5,
its plain version and the rect-kernel dilate/erode family.

Counterpart of ``mia_tpu/ops/morphology.py``. Masks are ``(..., H, W)``;
every leading axis is a batch axis (the JAX functions take one mask and are
vmapped). Labels converge to the minimum linear pixel index of each
8-connected (``connectivity=2``) or 4-connected (``1``) component;
background is -1.

- :func:`dilate`, :func:`erode` — ``(2r+1)²`` max / min filters whose
  outside is -inf / +inf (``cv2`` rect-kernel semantics), as one max-pool;
  :func:`fill_hole` (closing), :func:`remove_cc` (opening),
  :func:`remove_small_regions` (components under a size, on converged
  labels) and :func:`gaussian_blur_threshold_smooth` (0/255 blur, threshold
  at 127) are built on them, on :func:`connected_components` and on
  ``ops/filters.py``.

- :func:`connected_components` — the plain PyTorch version. It runs the
  Pallas kernel's schedule (``_cc_kernel``) exactly: each sweep is a
  Hillis–Steele segmented min-scan along the rows, forward then reverse,
  the same along the columns, then a masked diagonal min from one snapshot;
  exactly ``max_iters`` sweeps run (``None``: until no label changes). The
  labels equal the JAX package's ``connected_components(mask, connectivity,
  max_iters)`` bit for bit, converged or not.
- :func:`connected_components_fused` — the wrapper of the CUDA kernel
  ``csrc/connected_components.cu``, which replaces the TPU kernel
  ``connected_components_pallas``. A CUDA tensor launches the kernel (or
  raises); a CPU tensor takes the plain version. ``launches`` counts
  kernel launches.
- :func:`component_sizes_and_largest` — labels, per-pixel component size
  and the largest component(s) of each mask, through the wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import load_library
from .filters import gaussian_blur


def _window_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """``(2r+1)²`` running max of float ``(..., H, W)``; the outside is -inf."""
    h, w = x.shape[-2:]
    out = F.max_pool2d(x.reshape(-1, 1, h, w), 2 * radius + 1, stride=1, padding=radius)
    return out.reshape(x.shape)


def dilate(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Rect-kernel dilation, ``cv2.dilate(MORPH_RECT, 2r+1)`` semantics."""
    return _window_max(mask.to(torch.float32), radius).to(mask.dtype)


def erode(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Rect-kernel erosion; the outside is +inf (the ``cv2`` default), so it
    never erodes the interior: the processor zero-pads its masks first."""
    return (-_window_max(-mask.to(torch.float32), radius)).to(mask.dtype)


def fill_hole(mask: torch.Tensor, dilate_radius: int, erode_radius: int) -> torch.Tensor:
    """Morphological closing (dilate then erode)."""
    return erode(dilate(mask, dilate_radius), erode_radius)


def remove_cc(mask: torch.Tensor, dilate_radius: int, erode_radius: int) -> torch.Tensor:
    """Morphological opening (erode then dilate)."""
    return dilate(erode(mask, erode_radius), dilate_radius)


def gaussian_blur_threshold_smooth(mask: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """cv2-style boundary smoothing of ``(..., H, W)`` masks: 0/255 blur with
    the sigma ``cv2.GaussianBlur(sigma=0)`` derives from the kernel size, then
    threshold at 127."""
    sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    h, w = mask.shape[-2:]
    x = (mask > 0).to(torch.float32).reshape(-1, h, w, 1) * 255.0
    n = x.shape[0]
    blurred = gaussian_blur(x, torch.full((n,), sigma, device=x.device),
                            torch.full((n,), kernel_size, device=x.device),
                            max_kernel_size=kernel_size)
    return (blurred > 127).reshape(mask.shape).to(mask.dtype)


def _shift(x: torch.Tensor, shift: int, dim: int, fill: int) -> torch.Tensor:
    """``y[i] = x[i - shift]`` along ``dim``, ``fill`` entering at the vacated edge."""
    n = x.shape[dim]
    k = min(abs(shift), n)
    pad = torch.full_like(x.narrow(dim, 0, k), fill)
    if shift > 0:
        return torch.cat([pad, x.narrow(dim, 0, n - k)], dim)
    return torch.cat([x.narrow(dim, k, n - k), pad], dim)


def _seg_scan(v: torch.Tensor, bg: torch.Tensor, dim: int, reverse: bool, big: int) -> torch.Tensor:
    """Segmented running min along ``dim`` (background resets the run), as
    log-step shifts: out-of-range reads act as boundaries."""
    b = bg
    d = 1
    n = v.shape[dim]
    while d < n:
        sh = -d if reverse else d
        sv = _shift(v, sh, dim, big)
        sb = _shift(b, sh, dim, 1)
        v = torch.where(b != 0, v, torch.minimum(v, sv))
        b = b | sb
        d *= 2
    return v


def connected_components(mask: torch.Tensor, connectivity: int = 2,
                         max_iters: int | None = 16) -> torch.Tensor:
    """Plain K5: int32 labels of ``mask`` ``(..., H, W)`` after exactly
    ``max_iters`` sweeps, or with ``None`` once a sweep changes no label (at
    most ``H·W`` sweeps); -1 on background."""
    h, w = mask.shape[-2:]
    fg = mask > 0
    big = h * w
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device).view(h, w)
    lab = torch.where(fg, idx, torch.full_like(idx, big))
    bg = (~fg).to(torch.int32)
    diagonals = ((-1, -1), (-1, 1), (1, -1), (1, 1)) if connectivity == 2 else ()
    for _ in range(h * w if max_iters is None else max_iters):
        before = lab
        for dim in (-1, -2):
            lab = _seg_scan(lab, bg, dim, False, big)
            lab = _seg_scan(lab, bg, dim, True, big)
        src = torch.where(fg, lab, big)
        best = src
        for dy, dx in diagonals:
            best = torch.minimum(best, _shift(_shift(src, dy, -2, big), dx, -1, big))
        lab = torch.where(fg, best, big)
        if max_iters is None and torch.equal(lab, before):
            break
    return torch.where(fg, lab, -1)


def remove_small_regions(mask: torch.Tensor, min_size: int, connectivity: int = 2) -> torch.Tensor:
    """Zero out the connected components of ``(..., H, W)`` masks that hold
    fewer than ``min_size`` pixels (labels run to convergence)."""
    h, w = mask.shape[-2:]
    lab = connected_components(mask, connectivity, max_iters=None)
    flat = lab.reshape(-1, h * w).long()
    flat = torch.where(flat >= 0, flat, h * w)
    sizes = torch.zeros((flat.shape[0], h * w + 1), dtype=torch.int32, device=mask.device)
    sizes.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    keep = (torch.gather(sizes, 1, flat) >= min_size).reshape(mask.shape) & (lab >= 0)
    return torch.where(keep, mask, torch.zeros_like(mask))


@functools.cache
def _k5_functions():
    lib = load_library()
    run = lib.mia_connected_components_i32
    run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    run.restype = ctypes.c_int
    scratch = lib.mia_connected_components_scratch_elems
    scratch.argtypes = [ctypes.c_int] * 3
    scratch.restype = ctypes.c_longlong
    return run, scratch


def _launch_k5(mask: torch.Tensor, connectivity: int = 2, max_iters: int = 16) -> torch.Tensor:
    """Launch the CUDA kernel on ``(..., H, W)``; raise on anything it does not take."""
    if mask.device.type != "cuda":
        raise ValueError(f"K5 needs a CUDA tensor, got {mask.device}")
    if mask.dim() < 2:
        raise ValueError(f"K5 needs (..., H, W) masks, got shape {tuple(mask.shape)}")
    if connectivity not in (1, 2):
        raise ValueError(f"K5 connectivity must be 1 or 2, got {connectivity}")
    h, w = mask.shape[-2:]
    n = mask.numel() // max(h * w, 1)
    if h * w >= 2 ** 31 - 1 or n >= 2 ** 31:
        raise ValueError(f"K5 mask shape {tuple(mask.shape)} overflows int32 sizes")
    # the kernel reads m > 0: an int32 stack (prompt generation's) goes in as it is
    m = (mask if mask.dtype == torch.int32 and mask.is_contiguous()
         else (mask > 0).to(torch.int32).contiguous())
    out = torch.empty_like(m)
    run, scratch_elems = _k5_functions()
    with torch.cuda.device(mask.device):
        elems = scratch_elems(n, h, w)
        scratch = torch.empty(elems, dtype=torch.int32, device=mask.device) if elems else None
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = run(m.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                  n, h, w, int(max_iters), int(connectivity), stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed: cudaError {err}")
    connected_components_fused.launches += 1
    return out


def connected_components_fused(mask: torch.Tensor, connectivity: int = 2,
                               max_iters: int = 16) -> torch.Tensor:
    """K5: labels of ``(..., H, W)`` masks after ``max_iters`` sweeps.

    A CUDA tensor launches ``csrc/connected_components.cu`` (and raises if
    it cannot); a CPU tensor takes :func:`connected_components`.
    """
    if mask.device.type == "cpu":
        return connected_components(mask, connectivity, max_iters)
    return _launch_k5(mask, connectivity, max_iters)


connected_components_fused.launches = 0


def component_sizes_and_largest(mask: torch.Tensor, connectivity: int = 2, max_iters: int = 16):
    """(labels, size_map, largest) of ``(..., H, W)`` masks: each pixel's
    component size (0 on background) and the mask of the largest component
    (every one tied for largest), as in the JAX package."""
    h, w = mask.shape[-2:]
    lead = mask.shape[:-2]
    lab = connected_components_fused(mask, connectivity, max_iters)
    flat = lab.reshape(-1, h * w).long()
    flat = torch.where(flat >= 0, flat, h * w)
    sizes = torch.zeros((flat.shape[0], h * w + 1), dtype=torch.int32, device=mask.device)
    sizes.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    sizes[:, h * w] = 0
    size_map = torch.gather(sizes, 1, flat)
    largest = (size_map == size_map.amax(1, keepdim=True)) & (flat < h * w)
    return lab, size_map.reshape(*lead, h, w), largest.reshape(*lead, h, w)
