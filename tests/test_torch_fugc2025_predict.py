"""``fugc2025_predict_torch`` against ``mia_tpu``'s ``fugc2025_predict``.

Two seeded full-width ``LegacyUNet`` folds (the JAX ``model`` class fixes the
width), the JAX variables carried over by ``legacy_unet_state_dict_from_flax``;
the denoised class map equals the JAX ``model.predict`` on the same frame: 0
differing pixels allowed (float32 on both sides; the closest call of the
summed softmax's argmax on these frames is above float32 noise, checked in
the test; the fold heads are standardised so the classes follow the image).
"""

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from mia_tpu.entry.fugc2025.predict import model as JaxPredictModel
from mia_tpu.models.legacy_unet import LegacyUNet as JaxLegacyUNet
from mia_tpu.models.legacy_unet import LegacyUNetConfig as JaxLegacyConfig

import torch

from mia_tpu_torch.entry.fugc2025 import predict as predict_mod
from mia_tpu_torch.models import LegacyUNet, LegacyUNetConfig, legacy_unet_state_dict_from_flax


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    """Two seeded full-width LegacyUNet folds: JAX variables and the port's files."""
    root = tmp_path_factory.mktemp("folds")
    net = JaxLegacyUNet(JaxLegacyConfig(n_channels=3, n_classes=3))
    base = jax.device_get(net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(3)
    variables = []
    for fold in (0, 1):
        v = jax.tree_util.tree_map(
            lambda a: (np.asarray(a) * rng.uniform(0.8, 1.2, np.shape(a))
                       + (0.1 * np.std(a) + 0.01) * rng.standard_normal(np.shape(a))
                       ).astype(np.float32), base)
        v["batch_stats"] = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.1, v["batch_stats"])
        # random weights give one class everywhere: standardise the head's logits on a
        # seeded frame (computed with the port; it only shapes the weights both packages
        # load), so that the classes follow the image
        net = LegacyUNet(LegacyUNetConfig(n_channels=3, n_classes=3)).eval()
        v["params"]["outc"]["bias"] = np.zeros(3, np.float32)
        net.load_state_dict(legacy_unet_state_dict_from_flax(v))
        with torch.no_grad():
            logits = net(torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32)))
        std, mean = torch.std_mean(logits, (0, 1, 2))
        v["params"]["outc"]["kernel"] = v["params"]["outc"]["kernel"] / std.numpy()
        v["params"]["outc"]["bias"] = -(mean / std).numpy()
        variables.append(v)
        sd = legacy_unet_state_dict_from_flax(v)
        (root / f"fold_{fold}").mkdir()
        # one fold as the legacy file with the "model" key, one as the port's own
        if fold == 0:
            torch.save({"model": sd}, root / "fold_0" / "checkpoint_best.pth")
        else:
            torch.save(sd, root / "fold_1" / "model.pth")
    return root, variables


@pytest.mark.parametrize("image_size,frame", [([32], (40, 48)), (None, (32, 48))])
def test_ensemble_class_map_equals_the_jax_model(folds, image_size, frame):
    root, variables = folds
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:frame[0], 0:frame[1]]
    image = (120 + 80 * np.sin(xx / 5.0)[..., None] * np.cos(yy / 7.0)[..., None]
             + rng.normal(0, 25, (*frame, 3))).clip(0, 255).astype(np.uint8)
    jm = JaxPredictModel(image_size, folds=(0, 1))
    jm.variables = variables
    want = jm.predict(image.transpose(2, 0, 1))
    tm = predict_mod.model(image_size, folds=(0, 1), device="cpu").load(root)
    assert len(tm.nets) == 2 and not tm.nets[0].training
    got = tm.predict(image.transpose(2, 0, 1))
    assert got.shape == want.shape == frame and got.dtype == np.int32
    assert set(np.unique(got)) <= {0, 1, 2}
    assert (got != want).mean() == 0.0  # allowed fraction of differing pixels: 0
    assert len(np.unique(want)) >= 2  # the frame holds more than one class
    assert np.array_equal(tm.predict(image), got)  # (H, W, 3) layout too
    # the closest call of the raw argmax on this frame lies above the float32 noise of a
    # summed softmax (~1e-7), so exact agreement is no accident
    with torch.inference_mode():
        x = torch.from_numpy(image).float()[None] / 255.0
        if tm.image_size:
            from mia_tpu_torch.ops.resize import resize

            x = resize(x, tm.image_size, "bilinear", antialias=True)
        prob = sum(torch.softmax(net(x), -1) for net in tm.nets)
        top2 = prob.topk(2, -1).values
        assert (top2[..., 0] - top2[..., 1]).min() > 1e-6


def test_predict_entry_writes_class_maps_and_overlays(folds, tmp_path):
    root, _ = folds
    rng = np.random.default_rng(6)
    (tmp_path / "imgs").mkdir()
    for name, size in (("a.png", (40, 48)), ("b.png", (36, 44))):
        Image.fromarray((rng.random((*size, 3)) * 255).astype(np.uint8)).save(tmp_path / "imgs" / name)
    m = predict_mod.predict_entry([
        "--work-dir", str(root), "--device", "cpu", "--images", str(tmp_path / "imgs"),
        "--output-dir", str(tmp_path / "preds"), "--visualize-dir", str(tmp_path / "vis"),
        "--run-model", "--image-size", "32", "--folds", "0", "1"])
    assert m.image_size == (32, 32) and m.folds == [0, 1]
    for name, size in (("a.png", (40, 48)), ("b.png", (36, 44))):
        pred = np.array(Image.open(tmp_path / "preds" / name))
        assert pred.shape == size and set(np.unique(pred)) <= {0, 1, 2}
        assert np.array(Image.open(tmp_path / "vis" / name)).shape == (*size, 3)
    # without --run-model the overlays come from the stored predictions
    predict_mod.predict_entry(["--images", str(tmp_path / "imgs" / "a.png"),
                               "--output-dir", str(tmp_path / "preds"),
                               "--visualize-dir", str(tmp_path / "vis2")])
    assert np.array_equal(np.array(Image.open(tmp_path / "vis2" / "a.png")),
                          np.array(Image.open(tmp_path / "vis" / "a.png")))
    with pytest.raises(ValueError, match="output-dir or run-model"):
        predict_mod.predict_entry(["--images", str(tmp_path / "imgs")])
    with pytest.raises(FileNotFoundError, match="fold_4"):
        predict_mod.model(folds=[4], device="cpu").load(root)
