"""The port's CPC-SAM model and losses against ``mia_tpu``'s, from the same
weights (a narrow ``SamDualmask``: 64², embed 32, depth 2, 2 heads, block 1
global, LoRA rank 2), carried over by ``sam_state_dict_from_flax``.

Prompts are injected (the ``prompts=`` hook), so no RNG enters. Tolerances:

- image embedding and every decoder's low-res logits: max |port − JAX| ≤
  1e-5 · max |JAX|;
- the fixed-prompt phase-1 and phase-2 losses of the trainer's own
  composition (``CPCSAMTrainer.compute_losses``): 1e-5 relative;
- the LoRA gradients: max |port − JAX| ≤ 1e-4 · max |JAX| over all of them
  (float32: a tensor whose gradients are small beside the others carries
  rounding of the size of theirs).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.losses import DiceAndCELoss as JaxDiceCE
from mia_tpu.models.sam import SamDualmask as JaxSamDualmask

import torch

from mia_tpu_torch.models.sam import SamDualmask
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax
from mia_tpu_torch.training.cpcsam_trainer import CPCSAMTrainer

SIZE, BATCH, LBS, CLASSES, DICE_W = 64, 4, 2, 3, 0.8
KW = dict(img_size=SIZE, num_classes=CLASSES, encoder_embed_dim=32, encoder_depth=2,
          encoder_num_heads=2, encoder_global_attn_indexes=(1,), lora_rank=2)


def _seeded_params(tree, rng):
    """Seeded weights in the shapes of the JAX model's params (its own
    initialisers would take a compile): kernels N(0, 1/fan_in), norm scales
    1 + N(0, 0.01), everything else (biases, tables, embeddings, the LoRA B
    matrices that the reference zeroes) N(0, 0.01), so every path and every
    LoRA gradient carries signal."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _seeded_params(v, rng)
            continue
        x = rng.standard_normal(v.shape)
        if k == "kernel":
            x /= np.sqrt(np.prod(v.shape[:-1]))
        elif k == "scale" or (k == "weight" and len(v.shape) == 1):
            x = 1.0 + 0.1 * x
        else:
            x *= 0.1
        out[k] = x.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    jm = JaxSamDualmask(**KW, use_stacked_decoders=False)
    x = jnp.zeros((1, SIZE, SIZE, 3))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: jm.init({"params": k, "prompt": k, "dropout": k}, x, SIZE,
                                              method=jm.init_variables), key)
    params = _seeded_params(shapes["params"], np.random.default_rng(0))
    tm = SamDualmask(**KW)
    tm.load_state_dict(sam_state_dict_from_flax({"params": params}), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    images = rng.normal(60, 20, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.zeros((BATCH, SIZE, SIZE), np.int64)
    for i in range(BATCH):
        for c in (1, 2, 3):
            cy, cx = rng.uniform(10, SIZE - 10, 2)
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(5, 10) ** 2
            labels[i][m] = c
            images[i, :, :, c - 1][m] += 140.0
    c = CLASSES + 1
    coords = rng.uniform(5, SIZE - 5, (BATCH, c * 2, 2)).astype(np.float32)
    plabels = np.tile(np.repeat(np.arange(c), 2)[None], (BATCH, 1)).astype(np.int32)
    boxes = np.tile(np.asarray([[[8.0, 8.0], [50.0, 50.0]]], np.float32)[None], (BATCH, c - 1, 1, 1))
    box_labels = np.zeros((BATCH, c - 1), np.int32)
    mask_prompt = rng.random((BATCH, 16, 16, 1)).astype(np.float32)
    # one prompt tuple per decoder, each with its own points
    prompts = [((coords + k, plabels), (coords + 2.0 - k, plabels), (boxes, box_labels),
                (boxes * 1.1, box_labels), mask_prompt) for k in range(3)]
    return images, labels, prompts


def _to_torch(tree):
    if isinstance(tree, tuple):
        return tuple(_to_torch(t) for t in tree)
    return torch.from_numpy(np.array(tree))


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_embeddings_and_decoder_logits_match_jax(models, batch):
    jm, params, tm = models
    images, _, prompts = batch
    x, key = jnp.asarray(images), jax.random.PRNGKey(0)
    want_emb = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=jm.get_image_embeddings))(
        params, x)
    want = jax.jit(lambda p, x, e: jm.apply({"params": p}, x, True, SIZE, -1, None, e,
                                            rngs={"prompt": key}))(params, x, want_emb)
    want_p = jax.jit(lambda p, x, e, pr: jm.apply({"params": p}, x, True, SIZE, 1, ["all"], e,
                                                  prompts=pr, rngs={"prompt": key}))(
        params, x, want_emb, jax.tree.map(jnp.asarray, prompts[0]))
    with torch.no_grad():
        xt = torch.from_numpy(images)
        emb = tm.get_image_embeddings(xt)
        got = tm(xt, True, SIZE, -1, None, emb)
        got_p = tm(xt, True, SIZE, 1, ["all"], emb, prompts=_to_torch(prompts[0]))
    _close(emb, want_emb, 1e-5)
    for i in range(3):
        _close(got["low_res_logits"][i], want["low_res_logits"][i], 1e-5)
        _close(got["masks"][i], want["masks"][i], 1e-5)
        _close(got_p["low_res_logits"][i], want_p["low_res_logits"][i], 1e-5)
        _close(got["dense_features"][i], want["dense_features"][i], 1e-5)
    _close(got_p["low_res_logits_r"][1], want_p["low_res_logits_r"][1], 1e-5)
    _close(got_p["iou_predictions"][1], want_p["iou_predictions"][1], 1e-5)


def _jax_losses(jm, params, images, labels, phase2, prompts):
    """The JAX trainer's loss composition (labeled-only loss1, the phase-2
    sup/consistency terms) with injected prompts."""
    sup = JaxDiceCE(dice_weight=DICE_W, ce_weight=1 - DICE_W, smooth=1e-5, do_bg=True)

    def sup_w(logits, lbl, w):
        return sup(logits, lbl, dice_weight=w, ce_weight=1 - w)[0]

    def loss(p):
        x = jnp.asarray(images)
        y = jnp.asarray(labels, jnp.int32)
        emb = jm.apply({"params": p}, x if phase2 else x[:LBS], method=jm.get_image_embeddings)
        out = jm.apply({"params": p}, x[:LBS], True, SIZE, -1, None, emb[:LBS], train=True,
                       rngs={"prompt": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)})
        loss1 = sum(sup_w(out["low_res_logits"][i][:LBS], y[:LBS], DICE_W) for i in range(3))
        if not phase2:
            return loss1
        sup2 = sup2_r = cons2 = cons2_r = 0.0
        for k in range(3):
            out2 = jm.apply({"params": p}, x, True, SIZE, k, ["point"], emb, train=True,
                            prompts=jax.tree.map(jnp.asarray, prompts[k]),
                            rngs={"prompt": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(1)})
            lrl_p, lrl_pr = out2["low_res_logits"][k], out2["low_res_logits_r"][k]
            sup2 = sup2 + sup_w(lrl_p[:LBS], y[:LBS], DICE_W)
            sup2_r = sup2_r + sup_w(lrl_pr[:LBS], y[:LBS], DICE_W)
            ens = (jax.nn.softmax(lrl_p, -1) + jax.nn.softmax(lrl_pr, -1)) / 2.0
            pseudo = jax.lax.stop_gradient(jnp.argmax(ens[LBS:], -1))
            for o in range(3):
                if o != k:
                    cons2 = cons2 + sup_w(out2["low_res_logits"][o][LBS:], pseudo, 0.5)
            cons2_r = cons2_r + sup_w(lrl_pr[LBS:], pseudo, 0.5)
        return loss1 + (sup2 + sup2_r + 0.4 * cons2 + 0.05 * cons2_r)

    return jax.jit(jax.value_and_grad(loss))(params)


def check_fixed_prompt_losses(models, batch, phase2):
    """The trainer's loss and the LoRA gradients against the JAX
    composition's (phase 2 runs in ``test_torch_cpcsam_phase2.py``)."""
    jm, params, tm = models
    images, labels, prompts = batch
    want_loss, want_grads = _jax_losses(jm, params, images, labels, phase2, prompts)

    trainer = CPCSAMTrainer(device="cpu", config=dict(
        image_size=SIZE, num_classes=CLASSES, batch_size=BATCH, labeled_batch_ratio=0.5,
        lora_rank=2, dice_weight=DICE_W, promptmode=["point"], optimizer_name="adam"))
    trainer.model = tm
    trainer._setup_loss()
    trainer._setup_optimizer()
    total, loss1, loss2, _ = trainer.compute_losses(
        torch.from_numpy(images), torch.from_numpy(labels), 0, phase2,
        prompts=[_to_torch(p) for p in prompts] if phase2 else None)
    assert abs(total.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert (loss2.item() > 0) == phase2

    names = [n for n, p in tm.named_parameters() if "lora_" in n]
    assert len(names) == 8 and all(p.requires_grad == ("lora_" in n or not n.startswith(
        "image_encoder.")) for n, p in tm.named_parameters())
    grads = torch.autograd.grad(total, [dict(tm.named_parameters())[n] for n in names])
    want = sam_state_dict_from_flax({"params": jax.device_get(want_grads)})
    scale = max(float(np.abs(want[n].numpy()).max()) for n in names)
    for name, g in zip(names, grads):
        w = want[name].numpy()
        assert g.shape == w.shape and np.abs(w).max() > 0, name
        assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, name


def test_fixed_prompt_phase1_losses_and_lora_gradients_match_jax(models, batch):
    check_fixed_prompt_losses(models, batch, phase2=False)
