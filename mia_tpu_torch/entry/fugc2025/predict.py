"""``fugc2025_predict_torch`` console entry: the PyTorch port of
``fugc2025_predict`` (``mia_tpu/entry/fugc2025/predict.py``): k-fold ensemble
inference with the FUGC lip-class morphological postprocessing.

``model(image_size, folds).load(work_dir)`` then per PNG ``/255 → resize →
Σ_fold softmax(LegacyUNet(x)) → argmax → nearest resize back → fill-hole /
remove-cc / boundary-smooth of the object mask and the anterior-lip mask,
posterior refilled``, as whole-tensor programs on the device under
``torch.inference_mode()``.

Checkpoints, first found of each fold: the JAX package's flax
``fold_<i>/model.msgpack`` (read without flax, through
``utils/flax_msgpack.py`` and ``legacy_unet_state_dict_from_flax``), then
torch state dicts of the ``LegacyUNet`` with the reference ``_UNet``'s
names: ``fold_<i>/model.pth``, or the legacy ``fold_<i>/checkpoint_best.pth``
(with or without a ``"model"`` key). A checkpoint of another model fails
with the keys that differ.

``--device`` defaults to ``cuda`` and raises when no card is present; pass
``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from mia_tpu_torch.utils.common import draw_mask


class model:
    """Ensemble wrapper; name kept for the competition API."""

    def __init__(self, image_size=None, folds=(0, 1, 2, 3, 4), device="cuda"):
        from mia_tpu_torch.device import resolve_device, set_compute_precision
        from mia_tpu_torch.models.legacy_unet import LegacyUNetConfig
        from mia_tpu_torch.models.processor import UnetProcessor

        self.device = resolve_device(device)
        set_compute_precision("float32")
        self.dilate_size = 5
        self.erode_size = 5
        self.smooth_kernel = 7
        self.folds = list(folds)
        if image_size and len(image_size) < 2:
            image_size = list(image_size) * 2
        self.image_size = tuple(image_size) if image_size else None

        self.net_config = LegacyUNetConfig(n_channels=3, n_classes=3)
        self.nets: list = []
        self._processor = UnetProcessor(
            image_size=self.image_size,
            dilate_size=self.dilate_size,
            erode_size=self.erode_size,
            smooth_kernel=self.smooth_kernel,
        )

    def _fugc_denoise(self, mask: torch.Tensor) -> torch.Tensor:
        """FUGC class-priority denoise of an ``(H, W)`` class map: clean the
        object mask and the anterior-lip mask, refill posterior."""
        final_object = self._processor.clean_binary(mask > 0)
        final_ant = self._processor.clean_binary(mask == 1)
        final_ant = torch.where(final_object == 0, 0.0, final_ant)
        out = torch.where(final_object > 0, 2, 0)
        return torch.where(final_ant > 0, 1, out).to(torch.int32)

    @torch.inference_mode()
    def _ensemble(self, x: torch.Tensor) -> torch.Tensor:
        """x (1, H, W, 3) in [0, 1] → denoised (H, W) class map."""
        from mia_tpu_torch.ops.resize import resize

        h, w = x.shape[1], x.shape[2]
        xi = resize(x, self.image_size, "bilinear", antialias=True) if self.image_size else x
        prob = None
        for net in self.nets:
            p = torch.softmax(net(xi).to(torch.float32), dim=-1)
            prob = p if prob is None else prob + p
        mask = prob.argmax(-1).to(torch.int32)
        if self.image_size and self.image_size != (h, w):
            mask = resize(mask[..., None], (h, w), "nearest")[..., 0].to(torch.int32)
        return self._fugc_denoise(mask[0])

    def load(self, path="./"):
        from mia_tpu_torch.models.flax_bridge import legacy_unet_state_dict_from_flax
        from mia_tpu_torch.models.legacy_unet import LegacyUNet
        from mia_tpu_torch.models.torch_port import import_legacy_torch_checkpoint
        from mia_tpu_torch.utils.flax_msgpack import read_flax_msgpack

        self.nets = []
        for fold in self.folds:
            base = Path(path) / f"fold_{fold}"
            found = [p for p in (base / "model.msgpack", base / "model.pth",
                                 base / "checkpoint_best.pth") if p.is_file()]
            if not found:
                raise FileNotFoundError(f"no checkpoint under {base}")
            if found[0].suffix == ".msgpack":
                tree = read_flax_msgpack(found[0])
                if "inc" not in tree.get("params", {}):
                    raise ValueError(f"{found[0]} is not a state dict of LegacyUNet: its params "
                                     f"hold {sorted(tree.get('params', {}))[:3]}, not 'inc'")
                state = legacy_unet_state_dict_from_flax(tree)
            else:
                state = torch.load(found[0], map_location="cpu")
            net = import_legacy_torch_checkpoint(state, LegacyUNet(self.net_config))
            self.nets.append(net.to(self.device, memory_format=torch.channels_last).eval())
        return self

    def predict(self, X, no_normalization: bool = True) -> np.ndarray:
        """X: (3, H, W) uint8 (competition layout) or (H, W, 3)."""
        X = np.asarray(X)
        if X.ndim == 3 and X.shape[0] in (1, 3) and X.shape[-1] not in (1, 3):
            X = X.transpose(1, 2, 0)
        x = torch.from_numpy(np.ascontiguousarray(X)).to(self.device).to(torch.float32)[None] / 255.0
        return self._ensemble(x).cpu().numpy()

    def save(self, path="./"):
        pass


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--work-dir", default=".", type=str)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--images", required=True, type=str)
    parser.add_argument("--output-dir", type=str)
    parser.add_argument("--visualize-dir", type=str)
    parser.add_argument("--run-model", action="store_true")
    parser.add_argument("--image-size", nargs="+", type=int)
    parser.add_argument("--show", action="store_true")
    parser.add_argument("--folds", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    parser.add_argument("--batch-size", default=32, type=int)
    parser.add_argument("--no-normalization", action="store_true")
    return parser.parse_args(argv)


def predict_entry(argv=None):
    args = parse_args(argv)
    images_path = Path(args.images)
    output_dir = Path(args.output_dir) if args.output_dir else None
    visualize_dir = Path(args.visualize_dir) if args.visualize_dir else None
    for d in (output_dir, visualize_dir):
        if d:
            d.mkdir(parents=True, exist_ok=True)

    m = None
    if args.run_model:
        m = model(args.image_size, folds=args.folds, device=args.device).load(args.work_dir)

    images_iter = (
        sorted(images_path.glob("*.png")) if images_path.is_dir() else [images_path]
    )
    for image_path in images_iter:
        image_np = np.array(Image.open(image_path).convert("RGB"))
        if args.run_model:
            pred = m.predict(image_np.transpose(2, 0, 1), args.no_normalization)
            if output_dir:
                Image.fromarray(pred.astype(np.uint8)).save(output_dir / image_path.name)
        elif output_dir:
            pred = np.array(Image.open(output_dir / image_path.name))
        else:
            raise ValueError("Either output-dir or run-model must be specified")

        visualized = Image.fromarray(draw_mask(image_np, pred))
        if visualize_dir:
            visualized.save(visualize_dir / image_path.name)
        if args.show:
            visualized.show()
    return m


def main():
    predict_entry()


if __name__ == "__main__":
    main()
