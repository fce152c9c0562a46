"""The port's plain SAM registry entries take the JAX package's arguments and
build the same model: at a narrow ``_VIT_SPECS`` entry, ``vit_b`` with
``lora_rank=2`` has the JAX model's parameters name for name (through
``sam_state_dict_from_flax``, loaded strictly) and the same embedding within
1e-4 of max |JAX|. ``checkpoint`` is accepted and not read, as there."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.models.sam import build_sam as jax_build

import torch

from mia_tpu_torch.models.sam import build_sam
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax

NARROW = dict(embed_dim=32, depth=2, num_heads=2, global_idx=(1,))


@pytest.fixture
def narrow_specs(monkeypatch):
    monkeypatch.setitem(jax_build._VIT_SPECS, "vit_b", NARROW)
    monkeypatch.setitem(build_sam._VIT_SPECS, "vit_b", NARROW)
    # an entry reads its spec when the registry is made: make the entry again
    monkeypatch.setitem(jax_build.sam_model_registry, "vit_b", jax_build._build_plain("vit_b"))
    monkeypatch.setitem(build_sam.sam_model_registry, "vit_b", build_sam._build_plain("vit_b"))


def test_plain_registry_entry_builds_the_jax_model_with_lora(narrow_specs, tmp_path):
    jm, jside = jax_build.sam_model_registry["vit_b"](64, 3, checkpoint=None, lora_rank=2)
    tm, tside = build_sam.sam_model_registry["vit_b"](64, 3, checkpoint=str(tmp_path / "absent.pth"),
                                                      lora_rank=2)
    assert jside == tside == 4
    assert tm.image_encoder.blocks[0].attn.lora_rank == 2 == jm.lora_rank

    def init_all(mdl, x):  # the mask branch too, so every parameter exists
        mdl.prompt_encoder(masks=jnp.zeros((1, 16, 16, 1)))
        return mdl.forward_train(x, True, 64)

    variables = jax.jit(lambda key, x: jm.init(key, x, method=init_all))(
        jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(variables["params"]))
    missing, unexpected = tm.load_state_dict(sam_state_dict_from_flax({"params": params}), strict=True)
    assert not missing and not unexpected
    assert any("lora_" in k for k in tm.state_dict())
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), method=jm.get_image_embeddings))
    with torch.no_grad():
        got = tm.get_image_embeddings(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_registry_defaults_and_extra_arguments(narrow_specs):
    tm, _ = build_sam.sam_model_registry["vit_b"](64, 3)
    assert tm.image_encoder.blocks[0].attn.lora_rank == 0
    assert not any("lora_" in k for k in tm.state_dict())
    # keyword arguments meant for other entries are accepted, as in the JAX package
    build_sam.sam_model_registry["vit_b"](64, 3, dropout_rate=0.1, num_points_prompt=(1, 2))
    dual, side = build_sam.sam_model_registry["vit_b_dualmask_same_prompt_class_random_large"](
        64, 3, checkpoint="absent.pth", lora_rank=2)
    assert side == 4 and dual.num_decoders == 3
