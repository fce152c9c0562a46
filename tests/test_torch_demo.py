"""``demo_serve_torch`` and ``python -m mia_tpu_torch.cli`` against the JAX
package's ``demo_serve`` and CLI, on the CPU.

Both ``DemoSession``s load one flax ``model.msgpack`` of seeded weights
(the port through ``utils/flax_msgpack.py`` and
``unet_state_dict_from_flax``) and see the same 32x32 PNGs at
``image_size`` 32:

- ``predict_pseudo_label`` and ``predict_batch``: equal class maps, except
  at a pixel whose two largest JAX logits lie within 1e-4 (none here);
- the specialist features within 1e-5 of max |feature|;
- ``active_select``: the same picks, with the port's k-means++ fed the
  draws of JAX's ``PRNGKey(seed)`` (``selection.kmeans_plusplus_from_draws``:
  the documented ``torch.Generator`` deviation);
- ``editor_value``, ``accept`` for two picks and ``create_download_dataset``:
  equal editor layers, masks, and a zip whose PNGs are byte for byte the
  JAX session's.

The JAX package's own demo tests (``tests/test_demo_cli.py``) are ported
for the port's session alone: the full loop, the batched endpoint, the
stub-gradio ``serve_entry`` cycle, provider injection and recorded feature
files. ``visualize``'s PNG equals the JAX CLI's byte for byte.
"""

import sys
import types
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax import serialization

from mia_tpu.entry.demo.serve import DemoSession as JaxDemoSession
from mia_tpu_torch.activelearning import selectors
from mia_tpu_torch.activelearning.selection import kmeans_plusplus_from_draws
from mia_tpu_torch.entry.demo import serve
from mia_tpu_torch.entry.demo.serve import (CLASS_COLOR_MAP, DemoSession, file_feature_provider,
                                            hex_to_rgb, specialist_feature_provider)
from test_torch_selection import jax_kmeans_draws

SIZE = 32
GAP = 1e-4  # a class map may differ only where JAX's top-2 logit gap is below this


def _make_images(root, n, size=(SIZE, SIZE), seed=0):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        p = root / f"img_{i:02d}.png"
        Image.fromarray(rng.integers(0, 256, size, dtype=np.uint8)).save(p)
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """One JAX and one port session on the same seeded ``model.msgpack``."""
    root = tmp_path_factory.mktemp("demo")
    paths = _make_images(root / "images", 12)
    jax_session = JaxDemoSession(data_dir=root / "jax", budget=3, batch_size=2, image_size=SIZE)
    rng = np.random.default_rng(3)

    def seeded(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(leaf.shape[:-1])
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(leaf.shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(seeded, jax.device_get(jax_session.variables))
    ckpt = root / "model.msgpack"
    ckpt.write_bytes(serialization.to_bytes(variables))
    jax_session.load_specialist_model(ckpt)
    port = DemoSession(data_dir=root / "port", budget=3, batch_size=2, image_size=SIZE,
                       model_ckpt=ckpt, device="cpu")
    return jax_session, port, paths, root


def _gap_mask(jax_session, x):
    """Pixels whose two largest JAX logits lie within ``GAP``."""
    logits = np.asarray(jax_session.model.apply(jax_session.variables, jnp.asarray(x), train=False))
    top2 = np.sort(logits, -1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < GAP


def test_class_maps_match_jax(shared):
    jax_session, port, paths, _ = shared
    assert port.device.type == "cpu" and next(port.model.parameters()).device.type == "cpu"
    classes = set()
    for path in paths[:4]:
        image = Image.open(path)
        want = jax_session.predict_pseudo_label(image)
        got = port.predict_pseudo_label(image)
        assert got.shape == want.shape == (SIZE, SIZE) and got.dtype == want.dtype == np.int32
        x = np.asarray(image.convert("L"), np.float32)[None, ..., None] / 255.0
        assert not (got != want)[~_gap_mask(jax_session, x)[0]].any()
        classes |= set(np.unique(want))
    assert classes == {0, 1, 2}

    # another size: the batch is resized to the model size on the device
    x = np.random.default_rng(1).random((5, 40, 48, 1)).astype(np.float32)
    want, got = jax_session.predict_batch(x), port.predict_batch(x)
    assert got.shape == want.shape == (5, SIZE, SIZE)
    resized = np.asarray(jax_session.processor.preprocess(jnp.asarray(x)))
    assert not (got != want)[~_gap_mask(jax_session, resized)].any()


def test_specialist_features_match_jax(shared):
    from mia_tpu.data import ImageDataset as JaxImageDataset
    from mia_tpu.entry.demo.serve import specialist_feature_provider as jax_provider
    from mia_tpu_torch.data import ImageDataset

    jax_session, port, paths, _ = shared
    want = jax_provider(jax_session.model, jax_session.variables, 2)(
        JaxImageDataset(paths, image_channels=1, image_size=SIZE))
    got = specialist_feature_provider(port.model, port.device, 2)(
        ImageDataset(paths, image_channels=1, image_size=SIZE))
    assert list(got) == list(want) == paths
    scale = max(np.abs(v).max() for v in want.values())
    assert max(np.abs(got[k] - want[k]).max() for k in want) <= 1e-5 * scale


def test_session_loop_matches_jax(shared, monkeypatch):
    """active_select → editor_value → accept two picks → the zip, in both packages."""

    def kmeans_plusplus(x, n_clusters, generator, sample_weight=None):
        weight = None if sample_weight is None else sample_weight.cpu().numpy()
        first, uniforms = jax_kmeans_draws(generator.initial_seed(), x.shape[0], n_clusters,
                                           weight)
        return kmeans_plusplus_from_draws(x, first, torch.from_numpy(uniforms), sample_weight)

    monkeypatch.setattr(selectors, "kmeans_plusplus", kmeans_plusplus)
    jax_session, port, paths, root = shared
    for s in (jax_session, port):
        s.train_set, s.pool_set = paths[:4], paths[4:]
        s.feature_dict, s.annotated_set, s.feature_provider = None, [], None
    want = jax_session.active_select()
    got = port.active_select()
    assert [str(p) for p in got] == [str(p) for p in want] and len(got) == 3
    assert set(got) <= set(paths[4:])

    for k, pick in enumerate(got[:2]):
        value = port.editor_value(pick)
        jax_value = jax_session.editor_value(want[k])
        np.testing.assert_array_equal(value["background"], jax_value["background"])
        np.testing.assert_array_equal(value["layers"][0], jax_value["layers"][0])
        layer = np.zeros((SIZE, SIZE, 4), np.uint8)
        layer[4 + k:12, 5:15 + k] = hex_to_rgb(CLASS_COLOR_MAP[1]) + [255]
        layer[20:28, 18:30] = hex_to_rgb(CLASS_COLOR_MAP[2]) + [255]
        entry = port.accept(pick, value["background"], layer)
        jax_entry = jax_session.accept(want[k], jax_value["background"], layer)
        np.testing.assert_array_equal(entry["mask"], jax_entry["mask"])
        np.testing.assert_array_equal(entry["visual"], jax_entry["visual"])
    assert [str(p) for p in port.selected_set] == [str(p) for p in jax_session.selected_set]

    zips = [s.create_download_dataset() for s in (port, jax_session)]
    contents = []
    for z in zips:
        with zipfile.ZipFile(z) as archive:
            contents.append({n: archive.read(n) for n in archive.namelist()})
    stems = sorted(f"{p.rsplit('/', 1)[-1][:-4]}.png" for p in got[:2])
    assert sorted(contents[0]) == sorted(f"{d}/{s}" for d in ("images", "labels") for s in stems)
    assert contents[0] == contents[1]


# --- the JAX package's demo tests, on the port's session ------------------------


def test_demo_session_full_loop(tmp_path):
    paths = _make_images(tmp_path, 8)
    session = DemoSession(data_dir=tmp_path / "data", budget=2, batch_size=2, image_size=SIZE,
                          device="cpu")
    session.train_set = paths[:2]
    session.pool_set = paths[2:]

    selected = session.active_select()
    assert len(selected) == 2
    assert set(selected) <= set(paths[2:])

    pseudo = session.predict_pseudo_label(Image.open(selected[0]))
    assert pseudo.shape == (SIZE, SIZE)
    assert set(np.unique(pseudo)) <= {0, 1, 2}

    value = session.editor_value(selected[0])
    assert value["background"].shape == (SIZE, SIZE, 4)
    assert value["layers"][0].shape == (SIZE, SIZE, 4)

    layer = np.zeros((SIZE, SIZE, 4), np.uint8)
    layer[5:10, 5:10] = hex_to_rgb(CLASS_COLOR_MAP[1]) + [255]
    entry = session.accept(selected[0], value["background"], layer)
    assert (entry["mask"][5:10, 5:10] == 1).all()
    assert len(session.annotated_set) == 1
    assert selected[0] not in session.selected_set

    zip_path = session.create_download_dataset()
    with zipfile.ZipFile(zip_path) as z:
        names = z.namelist()
    assert any(n.startswith("images/") for n in names)
    assert any(n.startswith("labels/") for n in names)


def test_demo_batched_inference(tmp_path, rng):
    session = DemoSession(data_dir=tmp_path, image_size=SIZE, device="cpu")
    images = rng.random((4, SIZE, SIZE, 1)).astype(np.float32)
    preds = session.predict_batch(images)
    assert preds.shape == (4, SIZE, SIZE)


def test_demo_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DemoSession(data_dir=tmp_path, image_size=SIZE)
    monkeypatch.setitem(sys.modules, "gradio", None)  # not installed: a clean exit
    with pytest.raises(SystemExit, match="gradio"):
        serve.main([])


def test_serve_entry_drives_ui_cycle_against_stub_gradio(tmp_path, monkeypatch):
    """The full Gradio Blocks wiring against a recording stub ``gradio``
    module, driven through one upload → select → editor → accept → zip cycle
    by the registered event handlers."""
    events = {"launched": []}

    class _Component:
        def __init__(self, *a, **k):
            self.kwargs = k
            self.handlers = {}

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def _register(self, kind, fn, inputs=None, outputs=None):
            self.handlers.setdefault(kind, []).append((fn, inputs, outputs))

        def change(self, fn, inputs=None, outputs=None):
            self._register("change", fn, inputs, outputs)

        def click(self, fn, inputs=None, outputs=None):
            self._register("click", fn, inputs, outputs)

        def select(self, fn, inputs=None, outputs=None):
            self._register("select", fn, inputs, outputs)

        def launch(self, **k):
            events["launched"].append(k)

    made = {}

    def _tracking(name):
        def __init__(self, *a, **k):
            _Component.__init__(self, *a, **k)
            made.setdefault(name, []).append(self)

        return type(name, (_Component,), {"__init__": __init__})

    gr = types.ModuleType("gradio")
    for name in ("Blocks", "Accordion", "Row", "Gallery", "Number", "Text", "Button",
                 "ImageEditor", "Brush", "DownloadButton"):
        setattr(gr, name, _tracking(name))
    gr.SelectData = type("SelectData", (), {})
    monkeypatch.setitem(sys.modules, "gradio", gr)

    session_box = []

    def make_session(*a, **k):
        s = DemoSession(data_dir=tmp_path / "data", budget=2, image_size=SIZE, **k)
        session_box.append(s)
        return s

    monkeypatch.setattr(serve, "DemoSession", make_session)
    serve.serve_entry(device="cpu")

    assert events["launched"] == [{"inbrowser": True}]
    session = session_box[0]
    assert session.device.type == "cpu"
    train_gallery, pool_gallery, selected_gallery, annotated_gallery = made["Gallery"]
    (select_button, accept_button) = made["Button"]
    (editor,) = made["ImageEditor"]

    paths = _make_images(tmp_path, 6)
    train_gallery.handlers["change"][0][0]([(p, None) for p in paths[:2]])
    pool_gallery.handlers["change"][0][0]([(p, None) for p in paths[2:]])
    assert session.train_set == paths[:2]
    assert session.pool_set == paths[2:]

    selected = select_button.handlers["click"][0][0]()
    assert len(selected) == 2 and set(selected) <= set(paths[2:])

    data = gr.SelectData()
    data.value = {"image": {"path": selected[0]}}
    value = selected_gallery.handlers["select"][0][0](data)
    assert value["background"].shape == (SIZE, SIZE, 4)

    layer = np.zeros((SIZE, SIZE, 4), np.uint8)
    layer[4:9, 4:9] = hex_to_rgb(CLASS_COLOR_MAP[1]) + [255]
    value["layers"] = [layer]
    out = accept_button.handlers["click"][0][0](value)
    assert len(out) == 4
    download = out[3]
    zip_path = download.kwargs["value"]
    assert download.kwargs["visible"] is True
    with zipfile.ZipFile(zip_path) as z:
        names = z.namelist()
    assert any(n.startswith("images/") for n in names)
    assert any(n.startswith("labels/") for n in names)
    assert len(session.annotated_set) == 1


def test_demo_feature_provider_injection(tmp_path):
    """A fake provider drops in for BiomedCLIP: active_select consumes ITS features."""
    imgs = _make_images(tmp_path, n=6)
    calls = []
    frng = np.random.default_rng(0)

    def fake_provider(dataset):
        feats = {}
        for i in range(len(dataset)):
            s = dataset.get_sample(i)
            feats[s["case_name"]] = frng.standard_normal(8).astype(np.float32)
        calls.append(len(feats))
        return feats

    session = DemoSession(data_dir=tmp_path, budget=2, image_size=SIZE,
                          feature_provider=fake_provider, device="cpu")
    session.train_set = imgs[:2]
    session.pool_set = imgs[2:]
    selected = session.active_select()
    assert len(selected) == 2
    assert calls == [2, 4], "the injected provider sees the train set, then the pool"
    assert all(str(s) in [str(p) for p in imgs[2:]] for s in selected)


def test_demo_recorded_feature_file_provider(tmp_path):
    """Recorded 512-d vectors (BiomedCLIP's shape), precomputed offline as an
    ``.npz``, drive the cold-start selection: deterministic, and a KeyError
    when a case is missing from the recording."""
    imgs = _make_images(tmp_path, n=6)
    frng = np.random.default_rng(7)
    vecs = {p: frng.standard_normal(512).astype(np.float32) for p in imgs}
    np.savez(tmp_path / "biomedclip.npz", **vecs)

    def run(path, data):
        s = DemoSession(data_dir=tmp_path / data, budget=2, image_size=SIZE,
                        loaded_feature_only=True, feature_provider=file_feature_provider(path),
                        device="cpu")
        s.train_set = imgs[:2]
        s.pool_set = imgs[2:]
        return s.active_select()

    first, second = run(tmp_path / "biomedclip.npz", "d"), run(tmp_path / "biomedclip.npz", "d")
    assert first == second, "recorded-vector selection must be deterministic"
    assert len(first) == 2 and set(first) <= set(imgs[2:])

    np.savez(tmp_path / "partial.npz", **{p: vecs[p] for p in imgs[:5]})
    with pytest.raises(KeyError):
        run(tmp_path / "partial.npz", "d2")


def test_file_feature_provider_reads_h5_as_jax_does(tmp_path):
    """An ``.h5`` recording (flat case names: h5 nests a name with slashes)
    gives the JAX provider's vectors; another suffix is refused."""
    from mia_tpu.entry.demo.serve import file_feature_provider as jax_provider

    h5py = pytest.importorskip("h5py")  # not on every machine: the port imports it lazily
    names = [f"case_{i:02d}" for i in range(5)]
    frng = np.random.default_rng(8)
    with h5py.File(tmp_path / "features.h5", "w") as f:
        for n in names:
            f[n] = frng.standard_normal(16)
    dataset = types.SimpleNamespace(case_names=lambda: names[1:4])
    got = file_feature_provider(tmp_path / "features.h5")(dataset)
    want = jax_provider(tmp_path / "features.h5")(dataset)
    assert list(got) == list(want) == names[1:4]
    for n in got:
        assert got[n].dtype == np.float32 and np.array_equal(got[n], want[n])
    with pytest.raises(ValueError, match="unsupported"):
        file_feature_provider(tmp_path / "features.csv")


def test_cli_visualize_matches_jax(tmp_path, rng):
    from mia_tpu.cli.__main__ import main as jax_main
    from mia_tpu_torch.cli.__main__ import main

    img, mask = tmp_path / "x.png", tmp_path / "m.png"
    Image.fromarray(rng.integers(0, 256, (16, 20), dtype=np.uint8)).save(img)
    Image.fromarray(rng.integers(0, 3, (16, 20), dtype=np.uint8)).save(mask)
    main(["-q", "visualize", "-f", str(img), "-m", str(mask), "-o", str(tmp_path / "port.png")])
    jax_main(["-q", "visualize", "-f", str(img), "-m", str(mask), "-o", str(tmp_path / "jax.png")])
    assert np.array(Image.open(tmp_path / "port.png")).shape == (16, 20, 3)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    # without a mask the image is written as it was read
    main(["-q", "visualize", "-f", str(img), "-o", str(tmp_path / "plain.png")])
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "plain.png")),
                                  np.array(Image.open(img)))
