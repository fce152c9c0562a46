"""``fugc2025_rle2mask_torch``: Label-Studio brush RLE → PNG masks + overlays
(reference ``src/entry/fugc2025/preprocess/rle2mask.py:79-135``), with the
reference's sub-threshold component denoise (diagonal connectivity) and
class-priority overwrite (posterior before anterior).

Host numpy only; the port's own copy of ``mia_tpu/entry/fugc2025/preprocess/rle2mask.py``."""

from __future__ import annotations

import json
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
from PIL import Image

from mia_tpu_torch.tools import decode_rle, remove_noise_diagonal
from mia_tpu_torch.utils.common import draw_mask

CLASS_DICT = {"anterior lip": 1, "posterior lip": 2}


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--image-dir", required=True)
    parser.add_argument("--label-dir", required=True)
    parser.add_argument("--mask-file", required=True)
    parser.add_argument("--save-dir", required=True)
    parser.add_argument("--threshold", type=int, required=True)
    parser.add_argument("--visualize", action="store_true")
    return parser.parse_args(argv)


def rle2mask_entry(argv=None):
    args = parse_args(argv)
    image_dir = Path(args.image_dir)
    label_dir = Path(args.label_dir)
    save_dir = Path(args.save_dir)
    for sub in ("images", "labels", "visualized"):
        (save_dir / sub).mkdir(exist_ok=True, parents=True)

    with open(args.mask_file) as f:
        data = json.load(f)

    for task in data:
        masks = task["annotations"][0]["result"]
        width = masks[0]["original_width"]
        height = masks[0]["original_height"]
        image_id = task["data"]["id"]

        final_mask = np.zeros((height, width), dtype=np.uint8)
        mask_dict = {}
        for mask in masks:
            rle = mask["value"]["rle"]
            label = CLASS_DICT[mask["value"]["brushlabels"][0]]
            mask_np = decode_rle(rle).reshape((height, width, 4))[:, :, 0]
            mask_np = np.where(mask_np > 0, 255, 0).astype(np.uint8)
            mask_dict[label] = remove_noise_diagonal(mask_np, args.threshold)

        for label in (2, 1):  # anterior overwrites posterior on overlap
            if label in mask_dict:
                final_mask[mask_dict[label] > 0] = label

        Image.fromarray(final_mask).save(save_dir / "labels" / f"{image_id}.png")
        image = Image.open(image_dir / f"{image_id}.png").convert("RGB")
        image.save(save_dir / "images" / f"{image_id}.png")
        Image.fromarray(draw_mask(np.array(image), final_mask)).save(
            save_dir / "visualized" / f"{image_id}.png"
        )

    # pre-labeled data passes through with the labeled_data_ prefix
    for label_path in label_dir.glob("*.png"):
        image_id = label_path.stem
        mask = Image.open(label_path).convert("L")
        mask.save(save_dir / "labels" / f"labeled_data_{image_id}.png")
        image_path = image_dir / f"labeled_data_{image_id}.png"
        if not image_path.is_file():
            continue
        image = Image.open(image_path).convert("RGB")
        image.save(save_dir / "images" / f"labeled_data_{image_id}.png")
        Image.fromarray(draw_mask(np.array(image), np.array(mask))).save(
            save_dir / "visualized" / f"labeled_data_{image_id}.png"
        )


def main():
    rle2mask_entry()


if __name__ == "__main__":
    main()
