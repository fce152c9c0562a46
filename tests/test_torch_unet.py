"""The port's UNet against the flax UNet from the same weights.

Flax init variables pass through ``unet_state_dict_from_flax`` into the
port (and into the reference-named ``tests/torch_ref.TorchUNet``). Eval
logits, train-mode logits and the BatchNorm running statistics after one
train-mode pass must agree — the running variance catches the
biased-vs-unbiased variance trap of ``torch.nn.BatchNorm2d``.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig
from mia_tpu_torch.models import UNet, UNetConfig, unet_state_dict_from_flax
from torch_ref import TorchUNet

CHANNELS = (8, 16, 32)


@functools.lru_cache(maxsize=None)
def _flax_unet():
    """The flax UNet and its init variables (shapes do not depend on the
    input size), with non-trivial running statistics for eval mode."""
    jm = JaxUNet(JaxUNetConfig(in_channels=3, out_classes=3,
                               channels_list=CHANNELS, dropout_prob=0.0))
    init = jax.jit(lambda k, x: jm.init(k, x, train=False))
    variables = jax.tree.map(np.asarray, init(jax.random.key(0), jnp.zeros((1, 16, 16, 3))))
    rng = np.random.default_rng(0)
    for scope in ("encoder", "decoder"):
        for stats in variables["batch_stats"][scope].values():
            n = stats["norm"]["mean"].shape
            stats["norm"]["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            stats["norm"]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return jm, variables


def _pair(seed=0, hw=(32, 48), batch=2):
    jm, variables = _flax_unet()
    x = np.random.default_rng(seed).normal(size=(batch, *hw, 3)).astype(np.float32)
    tm = UNet(UNetConfig(in_channels=3, out_classes=3,
                         channels_list=CHANNELS, dropout_prob=0.0))
    tm.load_state_dict(unet_state_dict_from_flax(variables))
    return jm, copy.deepcopy(variables), tm, x


def test_eval_logits_match_flax():
    jm, variables, tm, x = _pair()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 48, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("hw", [(32, 48), (16, 16)])
def test_train_logits_and_bn_running_stats_match_flax(hw):
    # (16, 16) leaves the deepest level 4x4 pixels x batch 2 = n 32, where
    # the unbiased variance would be 1/31 (3%) off
    jm, variables, tm, x = _pair(hw=hw, seed=1)
    want, mutated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)

    sd = tm.state_dict()
    stats = mutated["batch_stats"]
    for scope, prefix in (("encoder", "encoder.levels"), ("decoder", "decoder.levels")):
        for name, s in stats[scope].items():
            level, block = name.removeprefix("level").split("_block")
            key = f"{prefix}.{level}.{block}.all.2"
            np.testing.assert_allclose(sd[f"{key}.running_mean"].numpy(),
                                       np.asarray(s["norm"]["mean"]), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(sd[f"{key}.running_var"].numpy(),
                                       np.asarray(s["norm"]["var"]), rtol=1e-5, atol=1e-6)


def test_reference_named_keys_load_into_reference_unet():
    jm, variables, tm, x = _pair()
    sd = unet_state_dict_from_flax(variables)
    ref = TorchUNet(3, 3, CHANNELS)
    ref.load_state_dict(sd)  # strict: every reference key, no extras
    assert set(sd) == set(tm.state_dict())
    ref.eval()
    with torch.no_grad():
        got = ref(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_init_matches_flax_distribution():
    """lecun-normal (truncated) kernels, zero biases, unit BN scales."""
    torch.manual_seed(0)
    tm = UNet(UNetConfig(in_channels=3, out_classes=3, channels_list=(32, 64)))
    w = tm.encoder.levels[1][1].all[0].weight  # 64 x 64 x 3 x 3, fan_in 576
    assert abs(w.std().item() - (1.0 / 576) ** 0.5) < 2e-3
    assert w.abs().max().item() <= 2.0 * (1.0 / 576) ** 0.5 / 0.87962566103423978 + 1e-6
    assert not tm.encoder.levels[0][0].all[0].bias.any()
    assert torch.equal(tm.encoder.levels[0][0].all[2].weight, torch.ones(32))


def test_channel_dropout_uses_the_callers_generator():
    tm = UNet(UNetConfig(in_channels=1, out_classes=2, channels_list=(4, 8), dropout_prob=0.5))
    tm.train()
    x = torch.rand(2, 16, 16, 1)
    a = tm(x, torch.Generator().manual_seed(3))
    b = tm(x, torch.Generator().manual_seed(3))
    c = tm(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_eval_and_predict_steps_match_jax():
    from mia_tpu.training.state import TrainState as JaxTrainState
    from mia_tpu.training.steps import make_eval_step, make_predict_fn
    from mia_tpu_torch.training import TrainState, eval_step, make_optimizer, predict

    jm, variables, tm, x = _pair(seed=2)
    jstate = JaxTrainState(step=0, params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=None, tx=None, apply_fn=jm.apply)
    tstate = TrainState(tm, make_optimizer("adam", tm.parameters()))
    want = np.asarray(make_eval_step()(jstate, jnp.asarray(x)))
    got = eval_step(tstate, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    probs, labels = predict(tstate, torch.from_numpy(x))
    jprobs, jlabels = make_predict_fn()(jstate, jnp.asarray(x))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
