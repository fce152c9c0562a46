"""The ``cpcsam_train_torch`` path on the CPU, around the model parity of
``test_torch_cpcsam.py``.

- ``train_entry([... "--device", "cpu" ...])`` on ``synth_data.make_acdc``
  with a narrow encoder: 2 phase-1 and 2 phase-2 steps, one validation, the
  real test; frozen parameters bit-identical, the LoRA tensors moved, and
  the LoRA checkpoint round-trips (``--lora-ckpt`` with ``--test-only``).
- Prompt generation by its properties (its draws cannot match JAX's RNG).
- ``import_torch_sam_encoder`` against the JAX package's on a synthetic
  reference state dict; the h5 ACDC reader against the JAX package's.
"""

import logging

import numpy as np
import pytest
import torch

from mia_tpu.data.acdc import ACDCDataset as JaxACDCDataset
from mia_tpu.models.sam import import_torch_sam_encoder as jax_import_encoder
from mia_tpu_torch.data import ACDCDataset
from mia_tpu_torch.entry.cpcsam.train import train_entry
from mia_tpu_torch.models.sam import build_sam
from mia_tpu_torch.models.sam.build_sam import import_torch_sam_encoder
from mia_tpu_torch.models.sam.lora import load_lora_state_dict, lora_state_dict
from mia_tpu_torch.models.sam.prompt_generation import (distance_to_zero,
                                                         prompt_generate_random_fast)
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax
from mia_tpu_torch.ops import morphology
from mia_tpu_torch.training import cpcsam_trainer
from synth_data import make_acdc

NARROW = dict(embed_dim=32, depth=2, num_heads=2, global_idx=(1,))


@pytest.fixture(scope="module")
def acdc_root(tmp_path_factory):
    """The synthetic ACDC set with its images scaled to 0-255: SAM normalises
    pixels by ImageNet statistics in those units, and at [0, 1] the tokens
    barely differ, so a global block's q would get next to no gradient in
    four steps and its LoRA A could not be seen to move."""
    import h5py

    root = tmp_path_factory.mktemp("acdc")
    make_acdc(root, n_slices=8, n_vols=1, size=(64, 64), depth=2)
    for path in root.rglob("*.h5"):
        with h5py.File(path, "r+") as f:
            image = f["image"][()] * 255.0
            del f["image"]
            f.create_dataset("image", data=image.astype(np.float32))
    return root


def test_entry_trains_validates_tests_and_checkpoints_on_cpu(acdc_root, tmp_path, monkeypatch):
    monkeypatch.setitem(build_sam._VIT_SPECS, "vit_b", NARROW)
    monkeypatch.setitem(cpcsam_trainer.PATIENTS_TO_SLICES["ACDC"], "1", 4)
    snap, phases = {}, []

    class Recording(cpcsam_trainer.CPCSAMTrainer):
        def on_train_start(self):
            super().on_train_start()
            snap.update({n: p.detach().clone() for n, p in self.model.named_parameters()})

        def train_step(self, batch):
            phases.append(self.current_iter >= self.config.warmup_iter)
            super().train_step(batch)

    monkeypatch.setattr(cpcsam_trainer, "CPCSAMTrainer", Recording)
    common = ["--data-path", str(acdc_root), "--device", "cpu", "--image-size", "64",
              "--batch-size", "4", "--lora-rank", "2", "--quiet"]
    trainer = train_entry(common + ["--work-path", str(tmp_path), "--warmup-iter", "2",
                                    "--min-iter", "4", "--max-iter", "4",
                                    "--valid-freq-iter", "4", "--lr-warmup-iter", "1"])
    assert phases == [False, False, True, True]
    work = trainer.work_path
    log = (work / "log.txt").read_text()
    assert log.count("Valid results") == 1 and "Real test results" in log
    rows = (work / "test_mean.csv").read_text().splitlines()
    assert len(rows) == 4 and rows[0] == "class,DSC,HD,ASD,JC"
    assert (work / "predictions" / "patient100_frame01_pred.nii.gz").is_file()
    losses = [row["loss"] for row in trainer.epoch_train_outputs]
    assert all(np.isfinite(v) for row in losses for v in row)

    model = trainer.model
    lora = [n for n, _ in model.named_parameters() if "lora_" in n]
    assert len(lora) == 8
    for n, p in model.named_parameters():
        moved = not torch.equal(p.detach(), snap[n])
        if "lora_" in n:
            assert moved, n
        elif n.startswith("image_encoder."):
            assert not moved and not p.requires_grad, n

    # the LoRA checkpoint: adapters + everything outside the encoder
    state = torch.load(work / "final_model" / "lora.pth")
    assert set(state) == set(lora_state_dict(model))
    assert any(k.startswith("mask_decoder2.") for k in state)
    assert not any(k.startswith("image_encoder.") and "lora_" not in k for k in state)
    fresh = cpcsam_trainer.CPCSAMTrainer(device="cpu", config=dict(
        image_size=64, num_classes=3, lora_rank=2, seed=7))
    fresh._build_model()
    encoder_before = {k: v.clone() for k, v in fresh.model.image_encoder.state_dict().items()
                      if "lora_" not in k}
    load_lora_state_dict(fresh.model, state)
    for k, v in fresh.model.state_dict().items():
        if k in state:
            assert torch.equal(v, state[k]), k
        else:
            assert torch.equal(v, encoder_before[k.removeprefix("image_encoder.")]), k
    with pytest.raises(KeyError, match="mismatch"):
        load_lora_state_dict(fresh.model, {k: v for k, v in state.items() if "lora_a_q" not in k})

    tested = train_entry(common + ["--work-path", str(tmp_path / "test_only"), "--test-only",
                                   "--lora-ckpt", str(work / "final_model" / "lora.pth")])
    assert "Loaded LoRA checkpoint" in (tested.work_path / "log.txt").read_text()
    for k, v in lora_state_dict(tested.model).items():
        assert torch.equal(v, state[k]), k


def _probs_from_maps(maps, classes):
    """(N, H, W) class maps → one-hot-ish probabilities (N, H, W, C)."""
    onehot = torch.nn.functional.one_hot(torch.from_numpy(maps).long(), classes).float()
    return 0.1 + 0.8 * onehot


def _maps(rng, n=4, size=32):
    """Blob class maps; class 3 is absent from every other map, and class 2
    has two blobs of different size in each."""
    yy, xx = np.mgrid[0:size, 0:size]
    maps = np.zeros((n, size, size), np.int64)
    for i in range(n):
        cy, cx = rng.uniform(8, 24, 2)
        maps[i][(yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(4, 7) ** 2] = 1
        maps[i][(yy - 4) ** 2 + (xx - 26) ** 2 < 9] = 2
        maps[i][(yy - 26) ** 2 + (xx - 5) ** 2 < 4] = 2
        if i % 2 == 0:
            maps[i][20:27, 20:30] = 3
    return maps


@pytest.mark.parametrize("image_size", [32, 64])
def test_prompt_generation_properties(rng, image_size):
    classes, size, (n0, n1) = 4, 32, (1, 2)
    maps = _maps(rng, size=size)
    gen = torch.Generator().manual_seed(11)
    points, points_r, fit, loose, mask_prompt = prompt_generate_random_fast(
        _probs_from_maps(maps, classes), image_size, (16, 16), (n0, n1), (0.1, 0.2),
        max_compute_size=64, generator=gen)
    n, s = maps.shape[0], image_size // size
    assert points[0].shape == (n, classes * n1, 2) and points[1].shape == (n, classes * n1)
    assert fit[0].shape == (n, classes - 1, 2, 2) and loose[0].shape == fit[0].shape
    assert mask_prompt.shape == (n, 16, 16, 1)
    np.testing.assert_array_equal(mask_prompt[..., 0].numpy(), maps[:, ::2, ::2])
    assert not fit[1].any() and not loose[1].any()  # box labels: reference-bug parity
    masks = torch.from_numpy((maps[:, None] == np.arange(classes)[None, :, None, None])
                             .astype(np.int32))
    _, _, largest = morphology.component_sizes_and_largest(masks)
    dist = distance_to_zero(largest).numpy()
    largest = largest.numpy()
    pts = (points[0].numpy().reshape(n, classes, n1, 2) // s).astype(int)  # compute frame (x, y)
    pts_r = (points_r[0].numpy().reshape(n, classes, n1, 2) // s).astype(int)
    labels = points[1].numpy().reshape(n, classes, n1)
    np.testing.assert_array_equal(points_r[1].numpy(), points[1].numpy())
    for i in range(n):
        for c in range(classes):
            if not largest[i, c].any():  # absent class: class 0's first center, label 0
                assert not (maps[i] == c).any()
                assert (pts[i, c] == pts[i, 0, 0]).all() and (pts_r[i, c] == pts[i, 0, 0]).all()
                assert (labels[i, c] == 0).all()
                if c > 0:  # and a degenerate box there
                    for boxes in (fit[0], loose[0]):
                        assert (np.floor(boxes[i, c - 1].numpy() / s) == pts[i, 0, 0]).all()
                continue
            assert (labels[i, c] == (c if c > 0 else 0)).all()
            for x, y in pts[i, c]:  # centers: maxima of the largest component's distance map
                assert dist[i, c, y, x] == dist[i, c].max() > 0
            for x, y in pts_r[i, c]:
                assert largest[i, c, y, x]
            if c == 0:
                continue
            ys, xs = np.nonzero(largest[i, c])
            for boxes, rate in ((fit[0], 0.1), (loose[0], 0.2)):
                (x1, y1), (x2, y2) = boxes[i, c - 1].numpy() / s
                x2, y2 = (x2 - (s - 1) / s), (y2 - (s - 1) / s)  # the cell's outer edge
                jx, jy = np.floor((xs.max() - xs.min()) * rate), np.floor((ys.max() - ys.min()) * rate)
                assert xs.min() - jx <= x1 <= xs.min() and xs.max() <= x2 <= xs.max() + jx
                assert ys.min() - jy <= y1 <= ys.min() and ys.max() <= y2 <= ys.max() + jy
    # class 2's smaller blob never gets a point
    assert all(maps[i, y, x] == 2 and y < 10 for i in range(n) for x, y in pts[i, 2])


def test_import_torch_sam_encoder_matches_jax(rng, monkeypatch, tmp_path):
    """A synthetic reference checkpoint (2 blocks, global block 1, 48-token
    pos-embed) imported at 256² (16 tokens): pos-embed and the global
    block's rel-pos tables resized; both imports carry the same weights, and
    the trainer's ``--model-ckpt`` path loads them into the encoder."""
    dim, depth, heads, side = 32, 2, 2, 48
    sd = {"image_encoder.patch_embed.proj.weight": rng.standard_normal((dim, 3, 16, 16)),
          "image_encoder.patch_embed.proj.bias": rng.standard_normal(dim),
          "image_encoder.pos_embed": rng.standard_normal((1, side, side, dim)),
          "image_encoder.neck.0.weight": rng.standard_normal((256, dim, 1, 1)),
          "image_encoder.neck.1.weight": rng.standard_normal(256),
          "image_encoder.neck.1.bias": rng.standard_normal(256),
          "image_encoder.neck.2.weight": rng.standard_normal((256, 256, 3, 3)),
          "image_encoder.neck.3.weight": rng.standard_normal(256),
          "image_encoder.neck.3.bias": rng.standard_normal(256),
          "mask_decoder.iou_token.weight": rng.standard_normal((1, 256))}
    for i in range(depth + 1):  # one block past the depth, dropped by both
        b = f"image_encoder.blocks.{i}."
        rel = 2 * side - 1 if i == 1 else 27
        sd.update({b + "norm1.weight": rng.standard_normal(dim), b + "norm1.bias": rng.standard_normal(dim),
                   b + "norm2.weight": rng.standard_normal(dim), b + "norm2.bias": rng.standard_normal(dim),
                   b + "attn.qkv.weight": rng.standard_normal((3 * dim, dim)),
                   b + "attn.qkv.bias": rng.standard_normal(3 * dim),
                   b + "attn.proj.weight": rng.standard_normal((dim, dim)),
                   b + "attn.proj.bias": rng.standard_normal(dim),
                   b + "attn.rel_pos_h": rng.standard_normal((rel, dim // heads)),
                   b + "attn.rel_pos_w": rng.standard_normal((rel, dim // heads)),
                   b + "mlp.lin1.weight": rng.standard_normal((4 * dim, dim)),
                   b + "mlp.lin1.bias": rng.standard_normal(4 * dim),
                   b + "mlp.lin2.weight": rng.standard_normal((dim, 4 * dim)),
                   b + "mlp.lin2.bias": rng.standard_normal(dim)})
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    got = import_torch_sam_encoder({k: torch.from_numpy(v) for k, v in sd.items()}, depth=depth,
                                   image_size=256, global_attn_indexes=(1,))
    want = jax_import_encoder(sd, depth=depth, image_size=256, global_attn_indexes=(1,))
    want = {k.removeprefix("image_encoder."): v for k, v in sam_state_dict_from_flax(
        {"params": {"image_encoder": want}}).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert got["pos_embed"].shape == (1, 16, 16, dim)
    assert got["blocks.1.attn.rel_pos_h"].shape == (31, dim // heads)
    assert got["blocks.0.attn.rel_pos_h"].shape == (27, dim // heads)
    monkeypatch.setitem(build_sam._VIT_SPECS, "vit_b", dict(embed_dim=dim, depth=depth,
                                                            num_heads=heads, global_idx=(1,)))
    build = build_sam.sam_model_registry["vit_b_dualmask_same_prompt_class_random_large"]
    model, _ = build(256, 3, lora_rank=2)
    missing, unexpected = model.image_encoder.load_state_dict(got, strict=False)
    assert not unexpected and all("lora_" in k for k in missing)

    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "sam.pth")
    trainer = cpcsam_trainer.CPCSAMTrainer(device="cpu", config=dict(
        image_size=256, num_classes=3, lora_rank=2, model_ckpt=str(tmp_path / "sam.pth")))
    trainer.logger = logging.getLogger("test_import_torch_sam_encoder")
    trainer._build_model()
    loaded = trainer.model.image_encoder.state_dict()
    for k, v in got.items():
        assert torch.equal(loaded[k], v), k


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_acdc_reader_matches_jax(tmp_path, split):
    make_acdc(tmp_path, n_slices=5, n_vols=2, size=(24, 20), depth=3)
    got, want = ACDCDataset(tmp_path, split=split), JaxACDCDataset(tmp_path, split=split)
    assert got.samples_list == want.samples_list
    for i in range(len(want)):
        a, b = got.get_sample(i), want.get_sample(i)
        assert set(a) == set(b) and a["case_name"] == b["case_name"]
        for key in ("image", "label", "spacing"):
            np.testing.assert_array_equal(a[key], b[key])
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype


def test_volume_validation_matches_jax(rng, tmp_path):
    """``test_single_volume`` (dice, hd95, loss) and ``test_single_volume_mean``
    (dice, hd, asd, jc) against the JAX package's, with a fixed three-decoder
    apply function: logits that peak at each class's intensity, so the
    argmax is far from a tie everywhere but at exact midpoints."""
    import jax.numpy as jnp

    from mia_tpu.losses import DiceAndCELoss as JaxDiceCE
    from mia_tpu.models.sam.validation import test_single_volume as jax_volume
    from mia_tpu.models.sam.validation import test_single_volume_mean as jax_volume_mean
    from mia_tpu_torch.losses import DiceAndCELoss
    from mia_tpu_torch.models.sam.validation import test_single_volume, test_single_volume_mean

    depth, h, w, classes = 3, 40, 48, 4
    yy, xx = np.mgrid[0:h, 0:w]
    label = np.zeros((depth, h, w), np.int32)
    for d in range(depth):
        for c in (1, 2, 3):
            cy, cx = rng.uniform(10, 30, 2)
            label[d][((yy - cy) / rng.uniform(4, 9)) ** 2 + ((xx - cx) / rng.uniform(4, 9)) ** 2 < 1] = c
    mu = np.array([0.1, 0.37, 0.61, 0.93], np.float32)
    image = np.repeat((mu[label] + rng.normal(0, 0.02, label.shape)).astype(np.float32)[..., None],
                      3, -1)
    scales = (50.0, 40.0, 60.0)

    def apply_fn(xp):
        def fn(x):
            masks = [-(x[..., :1] - xp.asarray(mu)) ** 2 * s for s in scales]
            return {"masks": masks, "low_res_logits": masks}
        return fn

    sup = dict(dice_weight=0.8, ce_weight=0.2, smooth=1e-5, do_bg=True)
    got, got_loss = test_single_volume(image[None], label[None], apply_fn(torch), classes,
                                       patch_size=(32, 32), loss_fn=DiceAndCELoss(**sup))
    want, want_loss = jax_volume(image[None], label[None], apply_fn(jnp), classes,
                                 patch_size=(32, 32), loss_fn=JaxDiceCE(**sup))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    spacing = (10.0, 1.48, 1.2)
    got = test_single_volume_mean(tmp_path, image, label, apply_fn(torch), classes,
                                  patch_size=(32, 32), raw_spacing=spacing)
    want = jax_volume_mean(tmp_path, image, label, apply_fn(jnp), classes, patch_size=(32, 32),
                           raw_spacing=spacing)
    assert len(got) == classes - 1
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("final,max_steps,interval", [(1.0, 0, 100), (0.1, 15000, 100), (2.5, 37, 4)])
def test_sigmoid_ramp_up_matches_jax(final, max_steps, interval):
    from mia_tpu.schedule import sigmoid_ramp_up as jax_ramp
    from mia_tpu_torch.schedule import sigmoid_ramp_up

    got, want = sigmoid_ramp_up(final, max_steps, interval), jax_ramp(final, max_steps, interval)
    for step in (0, 1, 3, 99, 100, 101, 5000, 14999, 15000, 20000):
        assert got(step) == pytest.approx(float(want(np.int64(step))), rel=1e-12, abs=1e-12)


def test_entry_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    from mia_tpu_torch.entry.cpcsam.train import parse_args

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    assert parse_args(["--data-path", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_entry(["--data-path", str(tmp_path), "--work-path", str(tmp_path)])
