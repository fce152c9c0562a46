"""The port's other datasets, NRRD I/O and the FUGC HD evaluator, held
against the JAX package on the same files (CPU).

- ``DATASETS`` holds the JAX registry's keys; BTCV raises as upstream.
- TN3K (per-fold trainval JSON, test directories) and TG3K (test == valid)
  JPG samples, labels binarised at > 127, at native size and resized: the
  JAX datasets' arrays.
- LA2018 on NRRD volumes (gzip and raw): the JAX dataset's ``(image,
  label)`` tuples; ``read_nrrd`` / ``write_nrrd`` round trips, the bytes the
  JAX writer writes.
- ACDC through ``read_case``: a subclass that serves the h5 file's arrays
  from memory gives the h5 dataset's samples.
- ``HD`` / ``cal_hd`` against the JAX package's.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from mia_tpu import data as jdata
from mia_tpu.metrics import HD as JaxHD, cal_hd as jax_cal_hd
from mia_tpu.utils.images import read_nrrd as jax_read_nrrd, write_nrrd as jax_write_nrrd
from mia_tpu_torch import data as tdata
from mia_tpu_torch.metrics import HD, cal_hd
from mia_tpu_torch.utils import read_nrrd, write_nrrd
from synth_data import make_acdc, make_tn3k


def _assert_same_sample(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_registry_holds_the_jax_keys():
    assert set(tdata.DATASETS) == set(jdata.DATASETS) == {
        "fugc", "busi", "acdc", "tn3k", "tg3k", "la2018", "btcv"}
    for key, cls in tdata.DATASETS.items():
        assert cls.__name__ == jdata.DATASETS[key].__name__
    with pytest.raises(NotImplementedError):
        tdata.DATASETS["btcv"]("anywhere")
    with pytest.raises(NotImplementedError):
        tdata.BTCVDataset.find_samples("anywhere")


def _write_tg3k(root, n=8, size=(30, 38), seed=1):
    rng = np.random.default_rng(seed)
    for d in ("thyroid-image", "thyroid-mask"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, size).astype(np.uint8)).save(
            root / "thyroid-image" / f"{i:04}.jpg")
        # grays around the 127 threshold: JPEG noise decides, the same file for both
        Image.fromarray(rng.integers(100, 156, size).astype(np.uint8)).save(
            root / "thyroid-mask" / f"{i:04}.jpg")
    (root / "tg3k-trainval.json").write_text(json.dumps({"train": [0, 2, 4, 6],
                                                         "val": [1, 3, 5, 7]}))
    return root


@pytest.mark.parametrize("image_size", [None, (24, 32)])
@pytest.mark.parametrize("channels", [1, 3])
def test_thyroid_samples_match_jax(tmp_path, image_size, channels):
    tn3k = make_tn3k(tmp_path / "tn3k", n=8, size=(30, 38))
    tg3k = _write_tg3k(tmp_path / "tg3k")
    for name, root in (("TN3KDataset", tn3k), ("TG3KDataset", tg3k)):
        for split in ("train", "valid", "test"):
            kw = dict(data_path=root, split=split, image_channels=channels, image_size=image_size)
            got, want = getattr(tdata, name)(**kw), getattr(jdata, name)(**kw)
            assert got.samples_list == want.samples_list and len(got) > 0
            for i in range(len(got)):
                g, w = got.get_sample(i), want.get_sample(i)
                _assert_same_sample(g, w)
                assert set(np.unique(g["label"])) <= {0, 1}
                assert g["image"].shape[-1] == channels
        assert [s["id"] for s in getattr(tdata, name).find_samples(root)] == [
            s["id"] for s in getattr(jdata, name).find_samples(root)]
    # TG3K tests on its valid split; TN3K on its test directories
    assert tdata.TG3KDataset(tg3k, split="test").samples_list == ["0001", "0003", "0005", "0007"]
    assert tdata.TN3KDataset(tn3k, split="test").samples_list == ["t000", "t001"]


def _write_la2018(root, shape=(4, 10, 12), seed=2):
    rng = np.random.default_rng(seed)
    for i, encoding in enumerate(("gzip", "raw")):
        patient = root / f"patient{i}"
        patient.mkdir(parents=True)
        jax_write_nrrd(patient / "lgemri.nrrd", rng.integers(0, 2000, shape).astype(np.int16),
                       encoding)
        jax_write_nrrd(patient / "laendo.nrrd", (rng.random(shape) < 0.3).astype(np.uint8),
                       encoding)
        jax_write_nrrd(patient / "lawall.nrrd", (rng.random(shape) < 0.2).astype(np.uint8),
                       encoding)
    unlabeled = root / "patient9"
    unlabeled.mkdir()
    jax_write_nrrd(unlabeled / "lgemri.nrrd", rng.random(shape).astype(np.float32))
    return root


def test_la2018_samples_match_jax(tmp_path):
    root = _write_la2018(tmp_path)
    for require_label in (True, False):
        got = tdata.LA2018Dataset(root, require_label=require_label)
        want = jdata.LA2018Dataset(root, require_label=require_label)
        assert got.samples_list == want.samples_list
        assert len(got) == (2 if require_label else 3)
        for i in range(len(got)):
            (gi, gl), (wi, wl) = got.get_sample(i), want.get_sample(i)
            for g, w in ((gi, wi), (gl, wl)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        assert set(np.unique(got.get_sample(0)[1])) == {0, 1, 2}
    assert (got.get_sample(2)[1] == -1).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.float32, np.float64])
@pytest.mark.parametrize("encoding", ["gzip", "raw"])
def test_nrrd_round_trip_and_jax_bytes(tmp_path, dtype, encoding):
    arr = (np.random.default_rng(3).random((3, 5, 7)) * 100).astype(dtype)
    write_nrrd(tmp_path / "port.nrrd", arr, encoding)
    jax_write_nrrd(tmp_path / "jax.nrrd", arr, encoding)
    assert (tmp_path / "port.nrrd").read_bytes() == (tmp_path / "jax.nrrd").read_bytes()
    for reader in (read_nrrd, jax_read_nrrd):
        back = reader(tmp_path / "port.nrrd")
        assert back.dtype == arr.dtype and back.shape == arr.shape
        np.testing.assert_array_equal(back, arr)


def test_nrrd_big_endian_and_bad_files(tmp_path):
    arr = np.arange(24, dtype=">i2").reshape(2, 3, 4)
    header = b"NRRD0004\ntype: short\ndimension: 3\nsizes: 4 3 2\nencoding: raw\nendian: big\n\n"
    (tmp_path / "be.nrrd").write_bytes(header + arr.tobytes())
    np.testing.assert_array_equal(read_nrrd(tmp_path / "be.nrrd"), arr.astype(np.int16))
    (tmp_path / "bad.nrrd").write_bytes(b"PNG\n")
    with pytest.raises(ValueError):
        read_nrrd(tmp_path / "bad.nrrd")


def test_acdc_read_case_serves_cases_from_memory(tmp_path):
    root = make_acdc(tmp_path, n_slices=4, n_vols=2, size=(20, 24), depth=3)
    for split in ("train", "valid", "test"):
        h5 = tdata.ACDCDataset(root, split=split, image_channels=3,
                               image_size=(16, 16) if split == "train" else None)
        cases = {c: h5.read_case(c) for c in h5.samples_list}

        class InMemory(tdata.ACDCDataset):
            def read_case(self, case):
                return cases[case]

        mem = InMemory(root, split=split, image_channels=3, image_size=h5.image_size)
        jax_ds = jdata.ACDCDataset(root, split=split, image_channels=3, image_size=h5.image_size)
        for i in range(len(h5)):
            _assert_same_sample(mem.get_sample(i), h5.get_sample(i))
            got, want = h5.get_sample(i), jax_ds.get_sample(i)
            for k in ("image", "label", "spacing"):
                np.testing.assert_array_equal(got[k], want[k])
            assert got["case_name"] == want["case_name"]


def _lip_maps(rng, n=3, size=(40, 48)):
    maps = np.zeros((n, *size), np.int64)
    yy, xx = np.mgrid[0:size[0], 0:size[1]]
    for m in maps:
        for cls in (1, 2):
            cy, cx = rng.uniform(0.3, 0.7) * size[0], rng.uniform(0.3, 0.7) * size[1]
            m[((yy - cy) / 6) ** 2 + ((xx - cx) / 8) ** 2 <= 1] = cls
    return maps


def test_hd_matches_jax():
    rng = np.random.default_rng(4)
    preds, labels = _lip_maps(rng), _lip_maps(rng)
    for p, l in zip(preds, labels):
        logits = np.eye(3, dtype=np.float32)[p][None]  # (1, H, W, 3)
        got, want = HD()(logits, l[None]), JaxHD()(logits, l[None])
        assert np.isfinite(got) and abs(got - want) <= 1e-5 * max(abs(want), 1.0)
        # channel-first logits and tensors
        got_cf = HD()(torch.from_numpy(logits.transpose(0, 3, 1, 2)), torch.from_numpy(l[None]))
        assert got_cf == pytest.approx(got, rel=1e-6)
        for spacing in (None, (1.5, 0.5)):
            assert cal_hd(p, l, spacing) == pytest.approx(jax_cal_hd(p, l, spacing), rel=1e-5)
    empty = np.zeros((8, 8), np.int64)
    assert cal_hd(empty, empty) == jax_cal_hd(empty, empty) == 0.0
    assert cal_hd(empty, preds[0][:8, :8] + 1) == np.inf == jax_cal_hd(empty, preds[0][:8, :8] + 1)


def test_hd_runs_on_the_device_of_its_input(monkeypatch):
    from mia_tpu_torch.metrics import hd_module

    seen = []

    def recording(a, b, spacing=None):
        seen.append((type(a), a.device, b.device))
        return surface_distance_stats(a, b, spacing)

    surface_distance_stats = hd_module.surface_distance_stats
    monkeypatch.setattr(hd_module, "surface_distance_stats", recording)
    rng = np.random.default_rng(5)
    p, l = _lip_maps(rng, n=1)[0], _lip_maps(rng, n=1)[0]
    logits = torch.from_numpy(np.eye(3, dtype=np.float32)[p][None])
    got = HD()(logits, torch.from_numpy(l[None]))
    assert got == pytest.approx(JaxHD()(logits.numpy(), l[None]), rel=1e-5)
    assert len(seen) == 3 and all(s == (torch.Tensor, logits.device, logits.device) for s in seen)
