"""The port's ``LegacyUNet`` against ``mia_tpu``'s, from the same weights.

Weights are the JAX model's (seeded init, batch statistics and biases drawn
at random so they carry signal), carried over by
``legacy_unet_state_dict_from_flax``; logits agree within 1e-4 of max |JAX|
(float32, another summation order). The JAX ``LegacyUNet(bilinear=True)``
cannot run (its ``resize`` has no ``align_corners`` argument), so the bilinear
setting is held against the reference's torch composition written out here
(``nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True)``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.models.legacy_unet import LegacyUNet as JaxLegacyUNet
from mia_tpu.models.legacy_unet import LegacyUNetConfig as JaxLegacyConfig
from mia_tpu.models.legacy_unet import import_legacy_torch_checkpoint as jax_import

import torch
import torch.nn as nn
import torch.nn.functional as F

from mia_tpu_torch.models import (
    LegacyUNet,
    LegacyUNetConfig,
    import_legacy_torch_checkpoint,
    legacy_unet_state_dict_from_flax,
)


def _seeded(tree, rng):
    """Replace every leaf but the conv kernels by seeded values (var positive)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _seeded(v, rng)
        elif k == "kernel":
            out[k] = np.asarray(v)
        elif k == "var" or k == "scale":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_model():
    cfg = JaxLegacyConfig(n_channels=3, n_classes=3, width=8)
    model = JaxLegacyUNet(cfg)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                          train=False))
    return model, _seeded(variables, np.random.default_rng(1))


@pytest.mark.parametrize("size", [(32, 32), (40, 52)])  # the second pads the upsampled maps
def test_logits_match_jax_through_the_bridge(jax_model, size):
    model, variables = jax_model
    x = np.random.default_rng(2).standard_normal((2, *size, 3)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    tm = LegacyUNet(LegacyUNetConfig(n_channels=3, n_classes=3, width=8)).eval()
    missing, unexpected = tm.load_state_dict(legacy_unet_state_dict_from_flax(variables), strict=True)
    assert not missing and not unexpected
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *size, 3)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_bridge_inverts_the_jax_importer_and_names_are_the_references(jax_model):
    _, variables = jax_model
    sd = legacy_unet_state_dict_from_flax(variables)
    for key in ("inc.double_conv.0.weight", "inc.double_conv.4.running_var",
                "down1.maxpool_conv.1.double_conv.3.weight", "up1.up.weight", "up4.up.bias",
                "up2.conv.double_conv.1.bias", "outc.conv.weight", "outc.conv.bias"):
        assert key in sd, key
    back = jax_import(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(np.asarray(leaf), flat_b[path]), jax.tree_util.keystr(path)
    n_flax = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(variables))
    assert sum(v.numel() for k, v in sd.items() if "num_batches" not in k) == n_flax


def test_features_without_a_head_and_train_mode_statistics(jax_model):
    model, variables = jax_model
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    headless = JaxLegacyUNet(JaxLegacyConfig(n_channels=3, n_classes=None, width=8))
    params = {k: v for k, v in variables["params"].items() if k != "outc"}
    hv = {"params": params, "batch_stats": variables["batch_stats"]}
    want = np.asarray(headless.apply(hv, jnp.asarray(x), train=False))
    tm = LegacyUNet(LegacyUNetConfig(n_channels=3, n_classes=None, width=8)).eval()
    tm.load_state_dict(legacy_unet_state_dict_from_flax(hv), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 8)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # train mode: batch statistics, and the running ones updated as flax does
    want, updates = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    full = LegacyUNet(LegacyUNetConfig(n_channels=3, n_classes=3, width=8)).train()
    full.load_state_dict(legacy_unet_state_dict_from_flax(variables))
    got = full(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - np.asarray(want)).max() <= 1e-4 * np.abs(np.asarray(want)).max()
    new_sd = legacy_unet_state_dict_from_flax({"params": variables["params"],
                                               "batch_stats": jax.device_get(updates["batch_stats"])})
    for k in ("inc.double_conv.1.running_mean", "up4.conv.double_conv.4.running_var"):
        np.testing.assert_allclose(full.state_dict()[k].numpy(), new_sd[k].numpy(),
                                   rtol=1e-4, atol=1e-5)


class _RefUp(nn.Module):
    """The reference ``Up`` with bilinear upsampling, written out."""

    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x1, x2):
        x1 = F.interpolate(x1, scale_factor=2, mode="bilinear", align_corners=True)
        dy, dx = x2.size(2) - x1.size(2), x2.size(3) - x1.size(3)
        x1 = F.pad(x1, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
        return self.conv(torch.cat([x2, x1], dim=1))


def test_bilinear_setting_matches_the_reference_composition():
    torch.manual_seed(4)
    tm = LegacyUNet(LegacyUNetConfig(n_channels=3, n_classes=3, width=8, bilinear=True)).eval()
    keys = set(tm.state_dict())
    assert not any(k.endswith(".up.weight") for k in keys)  # nn.Upsample holds no weights
    # halved mid-channels and bottleneck: up1's first conv maps 16w → 8w, down4 ends at 8w
    assert tm.up1.conv.double_conv[0].weight.shape == (64, 128, 3, 3)
    assert tm.down4.maxpool_conv[1].double_conv[3].weight.shape == (64, 64, 3, 3)
    assert tm.up4.conv.double_conv[3].weight.shape == (8, 8, 3, 3)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 40, 52, 3)).astype(np.float32))
    with torch.no_grad():
        got = tm(x)
        xi = x.permute(0, 3, 1, 2)
        x1 = tm.inc(xi)
        x2 = tm.down1(x1)
        x3 = tm.down2(x2)
        x4 = tm.down3(x3)
        y = tm.down4(x4)
        for up, skip in ((tm.up1, x4), (tm.up2, x3), (tm.up3, x2), (tm.up4, x1)):
            y = _RefUp(up.conv)(y, skip)
        want = tm.outc.conv(y).permute(0, 2, 3, 1)
    assert got.shape == (1, 40, 52, 3)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    with pytest.raises(TypeError):  # the JAX package's bilinear setting does not run
        jm = JaxLegacyUNet(JaxLegacyConfig(n_channels=3, n_classes=3, width=8, bilinear=True))
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)


def test_import_validates_keys_and_shapes(jax_model):
    _, variables = jax_model
    sd = legacy_unet_state_dict_from_flax(variables)
    net = LegacyUNet(LegacyUNetConfig(width=8))
    import_legacy_torch_checkpoint({"model": sd}, net)  # wrapped, as the fold files may be
    import_legacy_torch_checkpoint({k: v.numpy() for k, v in sd.items()
                                    if "num_batches" not in k}, net)  # numpy, no counters
    with pytest.raises(ValueError, match="shapes that differ"):
        import_legacy_torch_checkpoint(sd, LegacyUNet(LegacyUNetConfig(width=16)))
    from mia_tpu_torch.models import UNet, UNetConfig

    other = UNet(UNetConfig(in_channels=3, out_classes=3, channels_list=(4, 8))).state_dict()
    with pytest.raises(ValueError, match="not a state dict of LegacyUNet"):
        import_legacy_torch_checkpoint(other, net)
