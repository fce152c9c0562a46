"""``fugc2025_mask2rle_torch``: masks → Label-Studio brush-RLE project JSON
(reference ``src/entry/fugc2025/preprocess/mask2rle.py:67-120``).

Host numpy only; the port's own copy of ``mia_tpu/entry/fugc2025/preprocess/mask2rle.py``."""

from __future__ import annotations

import json
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
from PIL import Image

from mia_tpu_torch.tools import mask2annotation

PREFIX = {"label": "labeled_data_", "unlabel": "unlabeled_data_"}


def parse_args(argv=None):
    parser = ArgumentParser("Convert masks to label studio RLE format")
    parser.add_argument("--image-dir", required=True)
    parser.add_argument("--label-dir")
    parser.add_argument("--unlabel-dir")
    parser.add_argument("--output-path", required=True)
    return parser.parse_args(argv)


def _load_mask(dir_path: Path, image_id: str, image_number: str) -> np.ndarray:
    for name in (image_id, image_number):
        path = dir_path / f"{name}.png"
        if path.is_file():
            return np.array(Image.open(path).convert("L"))
    raise FileNotFoundError(f"no mask for {image_id} in {dir_path}")


def mask2rle_entry(argv=None):
    args = parse_args(argv)
    image_dir = Path(args.image_dir)
    label_dir = Path(args.label_dir) if args.label_dir else None
    unlabel_dir = Path(args.unlabel_dir) if args.unlabel_dir else None
    output_path = Path(args.output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)

    project_data = []
    for image_path in sorted(image_dir.glob("*.png")):
        image_id = image_path.stem
        if PREFIX["unlabel"] in image_id:
            image_number = image_id.replace(PREFIX["unlabel"], "")
            is_labeled = False
        else:
            image_number = image_id.replace(PREFIX["label"], "")
            is_labeled = True

        mask = _load_mask(
            label_dir if is_labeled else unlabel_dir, image_id, image_number
        )
        project_data.append(
            {
                "data": {
                    "image": f"http://localhost:8001/{image_dir / f'{image_id}.png'}",
                    "id": image_id,
                    "type": "labeled" if is_labeled else "unlabeled",
                },
                "predictions": [
                    mask2annotation(
                        mask,
                        {1: "anterior lip", 2: "posterior lip"},
                        "tag",
                        "image",
                    )
                ],
            }
        )

    with open(output_path, "w") as f:
        json.dump(project_data, f, indent=2)


def main():
    mask2rle_entry()


if __name__ == "__main__":
    main()
