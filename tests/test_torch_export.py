"""``mia_tpu_torch.models.export`` (``torch.export``) against the live modules
and against ``mia_tpu.models.export``'s loaded StableHLO programs.

- ``export_unet_forward`` of a 2D and a 3D UNet: the loaded program equals
  the live eval-mode forward, and the JAX package's exported program on the
  same weights (through the flax bridge) within 1e-5 of max |logit|; the
  model's training mode survives the export.
- ``export_sam_prompt_program`` of a narrow ``Sam``: the loaded program
  equals ``SamPredictor.decode_on_device`` on the same embedding and points
  (the predictor's padding point is the program's last slot), and the JAX
  package's program on the same weights, within 1e-5 of max |value|; the
  ``has_mask`` gate switches the mask prompt in.
- ``save_exported`` / ``load_exported`` through a file.
- ``ops/resize.py`` keeps a matrix made while ``torch.export`` traces out of
  its device cache.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig
from mia_tpu.models import export as jexport
from mia_tpu.models.sam import Sam as JaxSam
from mia_tpu_torch.models import UNet, UNetConfig, unet_state_dict_to_flax
from mia_tpu_torch.models import export
from mia_tpu_torch.models.sam import Sam, SamPredictor
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax

SAM_KW = dict(img_size=64, num_classes=3, encoder_embed_dim=32, encoder_depth=1,
              encoder_num_heads=2, encoder_global_attn_indexes=(0,))
TOL = 1e-5


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), f"{what}: max |diff| {err}"


@pytest.mark.parametrize("dimension", [2, 3])
def test_unet_forward_round_trip(dimension, tmp_path):
    torch.manual_seed(0)
    kw = dict(dimension=dimension, in_channels=1, out_classes=3, channels_list=(4, 8, 16))
    model = UNet(UNetConfig(**kw))
    shape = (1,) + (16,) * dimension + (1,)
    x = torch.from_numpy(np.random.default_rng(1).random(shape, np.float32))

    blob = export.export_unet_forward(model, x)
    assert model.training  # restored
    program = export.load_exported(blob)
    model.eval()
    with torch.no_grad():
        want = model(x)
    got = program(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # another input through the same program
    x2 = torch.from_numpy(np.random.default_rng(2).random(shape, np.float32))
    with torch.no_grad():
        _close(program(x2).detach().numpy(), model(x2).numpy(), "second input")

    # the JAX package's program on the same weights
    jm = JaxUNet(JaxUNetConfig(**kw))
    variables = unet_state_dict_to_flax(model.state_dict())
    jprogram = jexport.load_exported(jexport.export_unet_forward(jm, variables, jnp.asarray(x)))
    _close(got.detach().numpy(), jprogram(jnp.asarray(x.numpy())), "JAX program")

    path = export.save_exported(tmp_path / "unet.pt2", model, x)
    _close(export.load_exported(path)(x).detach().numpy(), want.numpy(), "from a file")


@pytest.fixture(scope="module")
def sams():
    jm = JaxSam(**SAM_KW)

    def init_all(mdl, x):  # the mask branch too, so every parameter exists
        mdl.prompt_encoder(masks=jnp.zeros((1, 16, 16, 1)))
        return mdl.forward_train(x, True, 64)

    variables = jax.jit(lambda key, x: jm.init(key, x, method=init_all))(
        jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)))
    variables = {"params": jax.device_get(variables["params"])}
    tm = Sam(**SAM_KW)
    tm.load_state_dict(sam_state_dict_from_flax(variables), strict=True)
    return jm, variables, tm.eval()


def _prompts(seed=0, points=4):
    rng = np.random.default_rng(seed)
    e = SAM_KW["img_size"] // 16
    emb = rng.standard_normal((1, e, e, 256)).astype(np.float32)
    coords = np.zeros((1, points, 2), np.float32)
    coords[0, :2] = [[10.0, 12.0], [30.0, 40.0]]
    labels = np.full((1, points), -1, np.int32)
    labels[0, :2] = [1, 0]
    mask = rng.standard_normal((1, 4 * e, 4 * e, 1)).astype(np.float32)
    return emb, coords, labels, mask


def test_sam_prompt_program_round_trip(sams):
    jm, variables, tm = sams
    emb, coords, labels, mask = _prompts()
    program = export.load_exported(export.export_sam_prompt_program(tm, max_points=4))
    args = [torch.from_numpy(a) for a in (emb, coords, labels, mask)]
    no_mask = torch.zeros(1)
    masks, iou, low_res = (o.detach() for o in program(*args, no_mask))
    e = SAM_KW["img_size"] // 16
    assert masks.shape == (1, 64, 64, 3) and iou.shape == (1, 3) and low_res.shape == (1, 4 * e, 4 * e, 3)

    # the live predictor on the same embedding: it appends one padding point
    # to the three prompt slots before the program's last (padding) slot
    predictor = SamPredictor(tm)
    predictor.features, predictor.is_image_set = args[0], True
    predictor.input_size = predictor.original_size = (64, 64)
    live_masks, live_iou, live_low = predictor.decode_on_device(
        (args[1][:, :3], args[2][:, :3]))
    _close(masks.permute(0, 3, 1, 2).numpy(), live_masks.numpy(), "masks vs predictor")
    _close(iou.numpy(), live_iou.numpy(), "iou vs predictor")
    _close(low_res.numpy(), live_low.numpy(), "low-res vs predictor")

    # the JAX package's program on the same weights, with and without the mask
    jprogram = jexport.load_exported(jexport.export_sam_prompt_program(jm, variables, max_points=4))
    for gate in (0.0, 1.0):
        has_mask = np.full((1,), gate, np.float32)
        got = program(*args, torch.from_numpy(has_mask))
        want = jprogram(emb, coords, labels, mask, has_mask)
        for g, w, what in zip(got, want, ("masks", "iou", "low-res")):
            _close(g.detach().numpy(), w, f"{what} vs JAX, has_mask {gate}")
    # the gate switches the mask prompt in
    assert not torch.allclose(program(*args, torch.ones(1))[0], masks)


def test_an_exported_resize_leaves_the_matrix_cache_eager():
    """``ops/resize.py`` caches its device matrices: one made while
    ``torch.export`` traces must not be cached for later eager calls."""
    from mia_tpu_torch.ops.resize import resize

    class Upscale(torch.nn.Module):
        def forward(self, x):
            return resize(x, (37, 41), "bilinear", antialias=False)

    x = torch.rand(1, 13, 11, 2)
    program = export.load_exported(export.export_apply(Upscale(), x))
    eager = resize(x, (37, 41), "bilinear", antialias=False)
    assert type(eager) is torch.Tensor and eager.shape == (1, 37, 41, 2)
    torch.testing.assert_close(program(x), eager, rtol=0, atol=0)
