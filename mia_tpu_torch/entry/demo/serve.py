"""``demo_serve_torch``: the human-in-the-loop AL demo on PyTorch.

Counterpart of ``mia_tpu/entry/demo/serve.py``. The session logic (feature
extraction → KMean selection → batched UNet pseudo-labels → accept → zip
dataset) lives in ``DemoSession``, testable without a UI; ``serve_entry``
wraps it in the same Gradio Blocks layout (gradio is import-guarded).

- The specialist model is the 32…512 UNet with 3 classes, on ``device``
  (``cuda`` unless the caller asks for the CPU). ``load_specialist_model``
  reads a ``.pth``/``.pt`` state dict (the reference UNet's names) or a flax
  ``model.msgpack`` written by either package.
- The batched endpoint (``predict_batch``, ``predict_pseudo_label``) runs
  ``UnetProcessor``'s resize, the UNet and the argmax on the device.
- Foundation features: BiomedCLIP through open_clip when it is installed,
  else the specialist UNet's bottleneck features (the JAX package's
  fall-back); ``file_feature_provider`` serves vectors recorded offline.
"""

from __future__ import annotations

import shutil
import uuid
import zipfile
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ...activelearning import KMeanSelector, ModelScorer
from ...activelearning.scorers import sweep_pool
from ...data import ActiveDataset, ExtendableDataset, ImageDataset
from ...device import resolve_device, set_compute_precision
from ...models import UNet, UNetConfig, UnetProcessor, unet_state_dict_from_flax
from ...models.torch_port import import_torch_unet_checkpoint
from ...utils.common import draw_mask
from ...utils.flax_msgpack import read_flax_msgpack

IMAGES_PER_ROW = 10
IMAGE_SIZE = 256

CLASS_COLOR_MAP = {1: "#ff0000", 2: "#00ff00"}


def hex_to_rgb(h: str) -> list[int]:
    h = h[1:]
    return [int(h[i : i + 2], 16) for i in range(0, 6, 2)]


class DemoSession:
    """State + operations behind the demo UI."""

    def __init__(
        self,
        data_dir: Path | str = "data",
        budget: int = 10,
        batch_size: int = 4,
        loaded_feature_weight: float = 1.0,
        sharp_factor: float = 1.0,
        loaded_feature_only: bool = False,
        model_ckpt: str | Path | None = None,
        image_size: int = IMAGE_SIZE,
        feature_provider=None,
        device: str | torch.device = "cuda",
    ):
        self.data_dir = Path(data_dir)
        self.budget = budget
        self.batch_size = batch_size
        self.loaded_feature_weight = loaded_feature_weight
        self.sharp_factor = sharp_factor
        self.loaded_feature_only = loaded_feature_only
        self.image_size = image_size
        self.device = resolve_device(device)
        set_compute_precision()

        self.train_set: list = []
        self.pool_set: list = []
        self.selected_set: list = []
        self.annotated_set: list = []
        self.feature_dict: dict | None = None
        # pluggable foundation-feature provider: callable(dataset) ->
        # {case_name: feature vector}; None -> BiomedCLIP when open_clip is
        # importable, else the specialist UNet's encoder features
        self.feature_provider = feature_provider
        self.current_dataset = "dataset"

        cfg = UNetConfig(
            dimension=2,
            in_channels=1,
            out_classes=3,
            channels_list=(32, 64, 128, 256, 512),
            block_type="plain",
            normalization="batch",
            dropout_prob=None,
        )
        with torch.random.fork_rng(devices=[]):  # seeded weights, the caller's RNG untouched
            torch.manual_seed(0)
            self.model = UNet(cfg)
        # channels-last weights, as the AL trainer keeps them: the NHWC input's
        # convolutions then run the trainer's cuDNN kernels
        self.model.to(self.device, memory_format=torch.channels_last).eval()
        self.processor = UnetProcessor(image_size=(image_size, image_size))
        if model_ckpt:
            self.load_specialist_model(model_ckpt)

    # -- model ------------------------------------------------------------
    def load_specialist_model(self, ckpt: str | Path):
        ckpt = Path(ckpt)
        if ckpt.suffix in (".pth", ".pt"):
            sd = torch.load(ckpt, map_location="cpu", weights_only=True)
        else:
            sd = unet_state_dict_from_flax(read_flax_msgpack(ckpt))
        import_torch_unet_checkpoint(sd, self.model)

    @torch.no_grad()
    def _predict(self, images: torch.Tensor) -> torch.Tensor:
        """The batched inference endpoint: (N, h, w, 1) model-size images →
        (N, h, w) int32 class maps."""
        self.model.eval()
        return torch.argmax(self.model(images), dim=-1).to(torch.int32)

    def predict_pseudo_label(self, image_pil: Image.Image) -> np.ndarray:
        """One image → (H, W) class map at the image's own size."""
        arr = np.asarray(image_pil.convert("L"), np.float32)[None, ..., None] / 255.0
        h, w = arr.shape[1], arr.shape[2]
        x = self.processor.preprocess(torch.from_numpy(arr).to(self.device))
        pred = self.processor.postprocess(self._predict(x), (h, w))
        return pred[0].cpu().numpy()

    def predict_batch(self, images: np.ndarray) -> np.ndarray:
        """Batched (N, H, W, 1) float32 → (N, h, w) class maps at the model size."""
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        return self._predict(self.processor.preprocess(x)).cpu().numpy()

    # -- features / selection ---------------------------------------------
    def _default_provider(self):
        try:  # BiomedCLIP (absent without open_clip → specialist fall-back)
            from open_clip import create_model_from_pretrained  # noqa: F401

            return biomedclip_feature_provider(device=self.device)
        except Exception:
            return specialist_feature_provider(self.model, self.device, self.batch_size)

    def _foundation_features(self, active_dataset: ActiveDataset) -> dict:
        provider = self.feature_provider
        if provider is None:
            provider = self.feature_provider = self._default_provider()
        feature_dict = {}
        for ds in (
            active_dataset.get_train_dataset(),
            active_dataset.get_pool_dataset(),
        ):
            if len(ds):
                feature_dict.update(provider(ds))
        return feature_dict

    def active_select(self) -> list:
        annotated_paths = [x["path"] for x in self.annotated_set]
        train_paths = list(set(list(self.train_set) + annotated_paths))
        train_dataset = ExtendableDataset(
            ImageDataset(train_paths, image_channels=1, image_size=self.image_size)
        )
        pool_dataset = ExtendableDataset(
            ImageDataset(self.pool_set, image_channels=1, image_size=self.image_size)
        )
        active_dataset = ActiveDataset(train_dataset, pool_dataset)
        if self.feature_dict is None:
            self.feature_dict = self._foundation_features(active_dataset)

        selector = KMeanSelector(
            batch_size=self.batch_size,
            metric="l2",
            feature_dict=self.feature_dict,
            loaded_feature_weight=self.loaded_feature_weight,
            sharp_factor=self.sharp_factor,
            loaded_feature_only=self.loaded_feature_only,
        )
        scorer = ModelScorer(self.model, self.device)
        self.selected_set = selector.select_next_batch(
            active_dataset, self.budget, scorer, seed=0
        )
        self.current_dataset = str(uuid.uuid4())
        return self.selected_set

    # -- annotation ---------------------------------------------------------
    def editor_value(self, image_path) -> dict:
        image_pil = Image.open(image_path).convert("L")
        background = np.array(image_pil.convert("RGBA"))
        pseudo = self.predict_pseudo_label(image_pil)
        layer = np.zeros_like(background)
        for cl, color in CLASS_COLOR_MAP.items():
            layer[pseudo == cl] = hex_to_rgb(color) + [255]
        return {"background": background, "layers": [layer], "composite": None}

    def accept(self, image_path, background: np.ndarray, layer: np.ndarray):
        """Brush layers → class mask, move to the annotated set."""
        binary = np.where(layer > 127, 255, 0)
        h, w = layer.shape[0], layer.shape[1]
        mask = np.zeros((h, w), np.uint8)
        for cl, color in CLASS_COLOR_MAP.items():
            hit = np.all(binary[:, :, :3] == hex_to_rgb(color), axis=-1)
            mask[hit] = cl
        rgb = background[..., :3]
        entry = {
            "path": str(image_path),
            "image": background,
            "mask": mask,
            "visual": draw_mask(rgb, mask),
        }
        self.selected_set = [x for x in self.selected_set if str(x) != str(image_path)]
        self.annotated_set.append(entry)
        return entry

    def create_download_dataset(self) -> Path:
        dataset_dir = self.data_dir / "dataset"
        if dataset_dir.exists():
            shutil.rmtree(dataset_dir)
        images_dir = dataset_dir / "images"
        labels_dir = dataset_dir / "labels"
        images_dir.mkdir(exist_ok=True, parents=True)
        labels_dir.mkdir(exist_ok=True, parents=True)
        zip_file = self.data_dir / "dataset.zip"
        with zipfile.ZipFile(zip_file, "w") as archive:
            for sample in self.annotated_set:
                case_name = Path(sample["path"]).stem
                Image.fromarray(sample["image"]).save(images_dir / f"{case_name}.png")
                Image.fromarray(sample["mask"]).save(labels_dir / f"{case_name}.png")
                archive.write(
                    images_dir / f"{case_name}.png", arcname=f"images/{case_name}.png"
                )
                archive.write(
                    labels_dir / f"{case_name}.png", arcname=f"labels/{case_name}.png"
                )
        return zip_file


def serve_entry(device: str = "cuda"):  # pragma: no cover - needs gradio
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "demo_serve_torch requires gradio, which is not installed in this image"
        ) from e

    session = DemoSession(device=device)

    with gr.Blocks() as demo:
        with gr.Accordion("Input"):
            with gr.Row():
                train_gallery = gr.Gallery(
                    label="Train set", allow_preview=False,
                    columns=IMAGES_PER_ROW // 2, show_label=True,
                )
                pool_gallery = gr.Gallery(
                    label="Pool set", allow_preview=False,
                    columns=IMAGES_PER_ROW // 2, show_label=True,
                )

            def gallery_change(image_list, target):
                if image_list is None:
                    return
                paths = [x[0] for x in image_list]
                if target == "train":
                    session.train_set = paths
                else:
                    session.pool_set = paths
                session.feature_dict = None

            train_gallery.change(
                lambda imgs: gallery_change(imgs, "train"), train_gallery, None
            )
            pool_gallery.change(
                lambda imgs: gallery_change(imgs, "pool"), pool_gallery, None
            )

        with gr.Accordion():
            budget_input = gr.Number(session.budget, label="Budget")
            model_ckpt_input = gr.Text("./init_model.msgpack", label="Specialist Model Checkpoint")
            batch_size_input = gr.Number(session.batch_size, label="Batch Size")
            weight_input = gr.Number(
                session.loaded_feature_weight, label="foundation_model_weight"
            )
            sharp_input = gr.Number(session.sharp_factor, label="sharp_factor")
            budget_input.change(lambda x: setattr(session, "budget", int(x)), budget_input, None)
            model_ckpt_input.change(
                lambda x: session.load_specialist_model(x), model_ckpt_input, None
            )
            batch_size_input.change(
                lambda x: setattr(session, "batch_size", int(x)), batch_size_input, None
            )
            weight_input.change(
                lambda x: setattr(session, "loaded_feature_weight", x), weight_input, None
            )
            sharp_input.change(
                lambda x: setattr(session, "sharp_factor", x), sharp_input, None
            )

        with gr.Accordion("Active Selection"):
            select_button = gr.Button("Select")
            with gr.Row():
                selected_gallery = gr.Gallery(
                    label="Selected samples", allow_preview=False,
                    columns=IMAGES_PER_ROW // 2, show_label=True,
                )
                annotated_gallery = gr.Gallery(
                    label="Annotated samples", allow_preview=True,
                    columns=IMAGES_PER_ROW // 2, show_label=True, interactive=False,
                )
            image_editor = gr.ImageEditor(
                label="Image Editor", interactive=True, sources=(),
                brush=gr.Brush(
                    colors=list(CLASS_COLOR_MAP.values()), color_mode="fixed"
                ),
                layers=False,
            )
            accept_button = gr.Button("Accept")
            download_button = gr.DownloadButton(
                label="Download Annotated Dataset", visible=False
            )

            select_button.click(lambda: session.active_select(), None, selected_gallery)

            state = {"selected_image": None}

            def gallery_select(data: gr.SelectData):
                state["selected_image"] = data.value["image"]["path"]
                return session.editor_value(state["selected_image"])

            selected_gallery.select(gallery_select, None, image_editor)

            def accept_click(value):
                if value and value.get("layers") and state["selected_image"]:
                    session.accept(
                        state["selected_image"], value["background"], value["layers"][0]
                    )
                zip_path = session.create_download_dataset()
                return (
                    None,
                    session.selected_set,
                    [x["visual"] for x in session.annotated_set],
                    gr.DownloadButton(value=str(zip_path), visible=True),
                )

            accept_button.click(
                accept_click,
                image_editor,
                [image_editor, selected_gallery, annotated_gallery, download_button],
            )

    demo.launch(inbrowser=True)


def main(argv=None):
    from argparse import ArgumentParser

    parser = ArgumentParser(prog="demo_serve_torch")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (the default; raises without a card) or cpu")
    serve_entry(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()


# ---------------------------------------------------------------------------
# foundation-feature providers (injectable into DemoSession)
# ---------------------------------------------------------------------------


def specialist_feature_provider(model, device, batch_size: int = 4):
    """Provider backed by the specialist UNet's bottleneck features
    averaged over space (``ModelScorer.enc_feature``)."""
    scorer = ModelScorer(model, device)

    def provider(dataset) -> dict:
        feats, names = sweep_pool(dataset, batch_size, scorer.enc_feature, scorer.device)
        return dict(zip(names, feats))

    return provider


def file_feature_provider(path):
    """Provider backed by RECORDED foundation-feature vectors.

    ``path`` is an ``.npz`` (case_name -> vector arrays) or ``.h5`` file of
    per-case vectors, e.g. BiomedCLIP embeddings precomputed offline on a
    machine where open_clip is installed. Cases absent from the file raise
    KeyError, so a stale recording is loud, not silently random.
    """
    path = Path(path)
    if path.suffix == ".npz":
        data = np.load(path)
        table = {k: np.asarray(data[k], np.float32) for k in data.files}
    elif path.suffix in (".h5", ".hdf5"):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"reading {path} needs h5py, which is not installed") from e

        with h5py.File(path, "r") as f:
            table = {k: np.asarray(f[k], np.float32) for k in f.keys()}
    else:
        raise ValueError(f"unsupported feature file: {path}")

    def provider(dataset) -> dict:
        return {name: table[name] for name in dataset.case_names()}

    return provider


def biomedclip_feature_provider(
    model_name: str = "hf-hub:microsoft/biomedclip-pubmedbert_256-vit_base_patch16_224",
    device: str | torch.device = "cuda",
):  # pragma: no cover - open_clip absent in this image
    """BiomedCLIP image-embedding provider. Requires ``open_clip``; raises
    ImportError otherwise so the caller can fall back."""
    from open_clip import create_model_from_pretrained

    device = resolve_device(device)
    model, preprocess = create_model_from_pretrained(model_name)
    model = model.to(device).eval()

    def provider(dataset) -> dict:
        feature_dict = {}
        for i in range(len(dataset)):
            sample = dataset.get_sample(i)
            img = Image.fromarray(
                (sample["image"][..., 0] * 255).astype(np.uint8)
            ).convert("RGB")
            with torch.no_grad():
                feat = model.encode_image(preprocess(img)[None].to(device))
            feature_dict[sample["case_name"]] = feat[0].cpu().numpy()
        return feature_dict

    return provider
