"""The rest of ``cpcsam_train``: the feature memory, the prototype
contrastive loss, VAT, the feature heads and the trainer's phase-1 losses
with each auxiliary flag against ``mia_tpu``'s, on seeded numpy inputs, and
the ``--resume`` round trip. The phase-2 losses with the flags run in
``test_torch_cpcsam_aux_phase2.py``, beside this file.

The two packages' generators differ, so nothing random enters a comparison:
the retain mask is all-true (dropout rate 0, as by default) or passed in,
and VAT's start noise is drawn from the port's generator and handed to the
JAX function in place of ``jax.random.uniform``.

Tolerances (float32): function values and losses 1e-5 relative; gradients
max |port − JAX| ≤ 1e-4 · the largest gradient compared (5e-4 for the feature
heads' parameters in the trainer comparison: their gradients are sums over
tens of thousands of pixel rows through masked batch statistics, taken in
another order by the two packages); the memory's valid
rows and flags exact where the scores are distinct or tied (a stable sort
breaks ties by index, as ``jax.lax.top_k`` does).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.losses import DiceAndCELoss as JaxDiceCE
from mia_tpu.losses.contrastive import prototype_contrastive_loss as jax_contrastive
from mia_tpu.losses.vat import vat_loss as jax_vat
from mia_tpu.memories import FeatureMemoryState as JaxMemory
from mia_tpu.memories import update_feature_memory as jax_update_memory

import torch

from mia_tpu_torch.losses import prototype_contrastive_loss, vat_loss
from mia_tpu_torch.memories import (FeatureMemoryState, init_feature_memory,
                                    update_feature_memory)
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax
from mia_tpu_torch.training.cpcsam_trainer import CPCSAMTrainer
from test_torch_cpcsam import (BATCH, CLASSES, DICE_W, LBS, SIZE, _to_torch, batch,  # noqa: F401
                               models)

W3 = 0.1  # loss3's weight once its ramp-up is over (loss3_weight_rampup_iter=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --- feature memory -----------------------------------------------------------


def _memory_inputs(rng, n=200, d=8, classes=4, ties=False):
    proj = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.integers(-1, classes, n).astype(np.int64)
    scores = rng.random((classes, n)).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4  # many equal scores: the order among them counts
    return proj, labels, scores


def _assert_memory_equal(got, want, tol=0.0):
    """The valid flags exact; the valid rows exact, or (features computed by
    the two packages) within ``tol`` of the largest."""
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    rows, want_rows = got.bank.numpy()[valid], np.asarray(want.bank)[valid]
    assert np.abs(rows - want_rows).max() <= tol * np.abs(want_rows).max()


@pytest.mark.parametrize("ties", [False, True])
def test_update_feature_memory_matches_jax(rng, ties):
    elements = 16
    got = init_feature_memory(3, 8, elements)
    want = JaxMemory(bank=jnp.zeros((4, elements, 8)), valid=jnp.zeros((4, elements), bool))
    assert got.bank.shape == (4, elements, 8) and not got.valid.any()
    for step in range(3):
        proj, labels, scores = _memory_inputs(rng, ties=ties)
        if step == 1:
            labels[labels == 2] = -1  # class 2 absent: its bank stays
            labels[(labels == 3) & (np.arange(len(labels)) > 20)] = -1  # class 3: a few rows only
        before = got
        got = update_feature_memory(got, _t(proj), _t(labels), _t(scores))
        want = jax_update_memory(want, jnp.asarray(proj), jnp.asarray(labels), jnp.asarray(scores))
        _assert_memory_equal(got, want)
        assert not got.bank[~got.valid].any()  # the port stores zeros past the count
        assert got.bank is not before.bank  # a new state, the old one untouched
    assert 0 < int(got.valid[3].sum()) < elements or got.valid[3].all()


def test_update_feature_memory_refuses_fewer_rows_than_the_bank(rng):
    with pytest.raises(ValueError, match="bank rows"):
        update_feature_memory(init_feature_memory(3, 8, 32), torch.zeros(10, 8),
                              torch.zeros(10, dtype=torch.long), torch.zeros(4, 10))


# --- prototype contrastive loss ----------------------------------------------


def _contrastive_inputs(rng, n=300, d=8, e=16, classes=4):
    pred = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.integers(0, classes, n).astype(np.int64)
    labels[labels == 3] = 0  # class 3 has no feature: it contributes 0
    retain = rng.random(n) < 0.8
    bank = rng.standard_normal((classes, e, d)).astype(np.float32)
    valid = rng.random((classes, e)) < 0.7
    valid[2] = False
    valid[2, 0] = True  # one bank row only: skipped
    sel = rng.standard_normal((classes, n)).astype(np.float32)
    sel_mem = rng.standard_normal((classes, e)).astype(np.float32)
    return pred, labels, retain, bank, valid, sel, sel_mem


def test_prototype_contrastive_loss_and_gradients_match_jax(rng):
    pred, labels, retain, bank, valid, sel, sel_mem = _contrastive_inputs(rng)

    def jax_loss(p, s, sm):
        return jax_contrastive(p, jnp.asarray(labels), jnp.asarray(retain),
                               JaxMemory(jnp.asarray(bank), jnp.asarray(valid)), s, sm, 3)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(pred), jnp.asarray(sel), jnp.asarray(sel_mem))
    leaves = [_t(a).requires_grad_() for a in (pred, sel, sel_mem)]
    got = prototype_contrastive_loss(leaves[0], _t(labels), _t(retain),
                                     FeatureMemoryState(_t(bank), _t(valid)), leaves[1],
                                     leaves[2], 3)
    assert float(want) > 0 and abs(got.item() - float(want)) <= 1e-5 * float(want)
    for g, w in zip(torch.autograd.grad(got, leaves), want_grads):
        assert _rel(g, w) <= 1e-4
    empty = prototype_contrastive_loss(_t(pred), _t(labels), _t(retain), init_feature_memory(3, 8, 16),
                                       _t(sel), _t(sel_mem), 3)
    assert empty.item() == 0.0  # an empty memory: no class has two rows


# --- VAT ----------------------------------------------------------------------


def test_vat_loss_and_gradients_match_jax(rng, monkeypatch):
    b, h, w, c, classes = 3, 6, 5, 4, 3
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    weights = [rng.standard_normal((c, classes)).astype(np.float32) for _ in range(2)]
    gen = torch.Generator().manual_seed(5)
    noise = torch.rand(x.shape, generator=torch.Generator().manual_seed(5))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, dtype: jnp.asarray(noise.numpy()))

    def jax_loss(x_, ws, clean):
        fwd = lambda e: [jnp.tanh(e) @ w_ for w_ in ws] + [None]  # noqa: E731
        return jax_vat(jax.random.PRNGKey(0), fwd, x_, xi=10.0, epi=6.0, ip=2,
                       clean_logits_list=clean)

    x_t = _t(x).requires_grad_()
    ws_t = [_t(w_).requires_grad_() for w_ in weights]
    fwd_t = lambda e: [torch.tanh(e) @ w_ for w_ in ws_t] + [None]  # noqa: E731
    for given_clean in (False, True):
        clean_j = [jnp.tanh(jnp.asarray(x)) @ w_ for w_ in weights] if given_clean else None
        want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1))(
            jnp.asarray(x), [jnp.asarray(w_) for w_ in weights], clean_j)
        gen.manual_seed(5)
        clean_t = [m.detach() for m in fwd_t(x_t)[:2]] if given_clean else None
        got = vat_loss(fwd_t, x_t, xi=10.0, epi=6.0, ip=2, clean_logits_list=clean_t, generator=gen)
        assert abs(got.item() - float(want)) <= 1e-5 * float(want)
        grads = torch.autograd.grad(got, [x_t, *ws_t])
        assert _rel(grads[0], want_grads[0]) <= 1e-4
        for g, w_ in zip(grads[1:], want_grads[1]):
            assert _rel(g, w_) <= 1e-4


# --- the feature heads (MaskedBatchNorm) --------------------------------------


def test_feature_heads_match_jax(models, rng):  # noqa: F811
    jm, params, tm = models
    feats = rng.standard_normal((50, 16)).astype(np.float32)
    mask = rng.random(50) < 0.6

    def head(name, *args):
        return jm.apply({"params": params}, *args, method=getattr(jm, name))

    with torch.no_grad():
        for m_j, m_t in ((jnp.asarray(mask), _t(mask)), (None, None)):
            proj_j = head("project_features", jnp.asarray(feats), m_j)
            proj_t = tm.project_features(_t(feats), m_t)
            assert _rel(proj_t, proj_j) <= 1e-5
            assert _rel(tm.predict_features(proj_t, m_t), head("predict_features", proj_j, m_j)) <= 1e-5
            for c in range(CLASSES + 1):
                for memory in (False, True):
                    assert _rel(tm.select_features(c, proj_t, m_t, memory),
                                head("select_features", c, proj_j, m_j, memory)) <= 1e-5


# --- the trainer's losses with the flags on -----------------------------------


def seeded_memory(rng, elements=32, dim=32):
    bank = rng.standard_normal((CLASSES + 1, elements, dim)).astype(np.float32)
    valid = rng.random((CLASSES + 1, elements)) < 0.5
    return bank, valid


def jax_aux_losses(jm, params, images, labels, phase2, prompts, memory, use_con, use_adv):
    """The JAX trainer's ``losses_fn`` written out (its closures are not
    importable) with injected prompts, all-true retain masks and the whole
    batch in both phases → ((total, loss3, new_memory), gradients)."""
    sup = JaxDiceCE(dice_weight=DICE_W, ce_weight=1 - DICE_W, smooth=1e-5, do_bg=True)
    keys = {"prompt": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)}
    x, y = jnp.asarray(images), jnp.asarray(labels, jnp.int32)
    n_cls = CLASSES + 1

    def sup_w(logits, lbl, w):
        return sup(logits, lbl, dice_weight=w, ce_weight=1 - w)[0]

    def contrastive_terms(p, mem, feats, lab):
        head = lambda name, *a: jm.apply({"params": p}, *a, method=getattr(jm, name))  # noqa: E731
        retain = jnp.ones(feats.shape[0], bool)
        proj = head("project_features", feats, retain)
        pred_f = head("predict_features", proj, retain)
        sel = jnp.stack([head("select_features", c, jax.lax.stop_gradient(pred_f), retain, False)[:, 0]
                         for c in range(n_cls)])
        sel_mem = jnp.stack([head("select_features", c, mem.bank[c], mem.valid[c], True)[:, 0]
                             for c in range(n_cls)])
        return jax_contrastive(pred_f, lab, retain, mem, sel, sel_mem, CLASSES)

    def loss(p):
        head = lambda name, *a: jm.apply({"params": p}, *a, method=getattr(jm, name))  # noqa: E731
        emb = jm.apply({"params": p}, x, method=jm.get_image_embeddings)
        out = jm.apply({"params": p}, x, True, SIZE, -1, None, emb, train=True, rngs=keys)
        loss1 = sum(sup_w(out["low_res_logits"][i][:LBS], y[:LBS], DICE_W) for i in range(3))
        groups = [(out["dense_features"][i], jnp.argmax(jax.nn.softmax(out["masks"][i], -1), -1))
                  for i in range(3)]
        loss2 = 0.0
        if phase2:
            sup2 = sup2_r = cons2 = cons2_r = 0.0
            for k in range(3):
                out2 = jm.apply({"params": p}, x, True, SIZE, k, ["point"], emb, train=True,
                                prompts=jax.tree.map(jnp.asarray, prompts[k]), rngs=keys)
                lrl_p, lrl_pr = out2["low_res_logits"][k], out2["low_res_logits_r"][k]
                groups.append((out2["dense_features"][k],
                               jnp.argmax(jax.nn.softmax(lrl_p, -1), -1)))
                sup2 = sup2 + sup_w(lrl_p[:LBS], y[:LBS], DICE_W)
                sup2_r = sup2_r + sup_w(lrl_pr[:LBS], y[:LBS], DICE_W)
                ens = (jax.nn.softmax(lrl_p, -1) + jax.nn.softmax(lrl_pr, -1)) / 2.0
                pseudo = jax.lax.stop_gradient(jnp.argmax(ens[LBS:], -1))
                for o in range(3):
                    if o != k:
                        cons2 = cons2 + sup_w(out2["low_res_logits"][o][LBS:], pseudo, 0.5)
                cons2_r = cons2_r + sup_w(lrl_pr[LBS:], pseudo, 0.5)
            loss2 = sup2 + sup2_r + 0.4 * cons2 + 0.05 * cons2_r
        loss3, new_memory = 0.0, memory
        if use_con:
            dim = groups[0][0].shape[-1]
            fl = jnp.concatenate([f[:LBS].reshape(-1, dim) for f, _ in groups])
            pl = jnp.concatenate([q[:LBS].reshape(-1) for _, q in groups])
            fu = jnp.concatenate([f[LBS:].reshape(-1, dim) for f, _ in groups])
            pu = jnp.concatenate([q[LBS:].reshape(-1) for _, q in groups])
            ll = jnp.concatenate([y[:LBS].reshape(-1)] * len(groups))
            correct = (pl == ll) & (pl > 0)
            proj_corr = head("project_features", jax.lax.stop_gradient(fl), correct)
            scores = jax.nn.sigmoid(jax.lax.stop_gradient(jnp.stack(
                [head("select_features", c, proj_corr, correct, False)[:, 0] for c in range(n_cls)])))
            new_memory = jax_update_memory(memory, jax.lax.stop_gradient(proj_corr),
                                           jnp.where(correct, ll, -1), scores)
            loss3 = 0.1 * (contrastive_terms(p, new_memory, fl, ll)
                           + contrastive_terms(p, new_memory, fu, pu))
        if use_adv:
            fwd = lambda e: jm.apply({"params": p}, x, True, SIZE, -1, None, e, train=True,  # noqa: E731
                                     rngs=keys)["low_res_logits"]
            loss3 = loss3 + 1.0 * jax_vat(
                jax.random.PRNGKey(0), fwd, emb, xi=10.0, epi=6.0, ip=1,
                clean_logits_list=[jax.lax.stop_gradient(m) for m in out["low_res_logits"]])
        return loss1 + loss2 + W3 * loss3, (loss3, new_memory)

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(params)


def aux_trainer(tm, **flags):
    trainer = CPCSAMTrainer(device="cpu", config=dict(
        image_size=SIZE, num_classes=CLASSES, batch_size=BATCH, labeled_batch_ratio=0.5,
        lora_rank=2, dice_weight=DICE_W, promptmode=["point"], optimizer_name="adam",
        loss3_weight_rampup_iter=0, **flags))
    trainer.model = tm
    trainer._setup_loss()
    trainer._setup_optimizer()
    return trainer


def check_aux_losses(models, batch, monkeypatch, phase2, use_con, use_adv):  # noqa: F811
    jm, params, tm = models
    images, labels, prompts = batch
    rng = np.random.default_rng(21)
    bank, valid = seeded_memory(rng)
    trainer = aux_trainer(tm, use_contrastive_loss=use_con, use_adv_loss=use_adv)
    if use_adv:  # VAT's draw is the generator's next: hand the same numbers to the JAX function
        peek = torch.Generator().manual_seed(0)
        peek.set_state(trainer.generator.get_state())
        if use_con:  # the two retain masks come first
            for count in ((3 + 3 * phase2) * LBS * SIZE * SIZE, (3 + 3 * phase2) * (BATCH - LBS) * SIZE * SIZE):
                torch.rand(count, generator=peek)
        noise = torch.rand((BATCH, SIZE // 16, SIZE // 16, 256), generator=peek).numpy()
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape, dtype: jnp.asarray(noise))
    (want_total, (want_l3, want_mem)), want_grads = jax_aux_losses(
        jm, params, images, labels, phase2, prompts,
        JaxMemory(jnp.asarray(bank), jnp.asarray(valid)), use_con, use_adv)

    total, _, loss2, loss3, new_memory = trainer.losses_and_memory(
        torch.from_numpy(images), torch.from_numpy(labels), 0, phase2,
        prompts=[_to_torch(p) for p in prompts] if phase2 else None,
        memory=FeatureMemoryState(_t(bank), _t(valid)) if use_con else None)
    assert float(want_l3) > 0 and (loss2.item() > 0) == phase2
    assert abs(loss3.item() - float(want_l3)) <= 1e-5 * float(want_l3)
    assert abs(total.item() - float(want_total)) <= 1e-5 * float(want_total)
    if use_con:
        assert trainer.memory is None  # compute-only: the trainer's state is its train step's
        _assert_memory_equal(new_memory, want_mem, tol=1e-5)
        assert int(new_memory.valid.sum()) > 0
    else:
        assert new_memory is None

    # LoRA adapters, and with the contrastive loss the heads it trains
    names = [n for n, p in tm.named_parameters() if "lora_" in n
             or (use_con and n.startswith(("projection_head", "prediction_head",
                                           "contrastive_class_selector")))]
    grads = torch.autograd.grad(total, [dict(tm.named_parameters())[n] for n in names],
                                allow_unused=True)
    want = sam_state_dict_from_flax({"params": jax.device_get(want_grads)})
    for group, tol in (("lora_", 1e-4), ("head", 5e-4), ("selector", 5e-4)):
        members = [(n, g) for n, g in zip(names, grads) if group in n]
        if not members:
            continue
        scale = max(float(want[n].abs().max()) for n, _ in members)
        assert scale > 0, group
        for n, g in members:
            g = torch.zeros_like(want[n]) if g is None else g
            assert float((g - want[n]).abs().max()) <= tol * scale, n


@pytest.mark.parametrize("use_con,use_adv", [(True, False), (False, True)])
def test_phase1_losses_with_an_auxiliary_flag_match_jax(models, batch, monkeypatch,  # noqa: F811
                                                        use_con, use_adv):
    check_aux_losses(models, batch, monkeypatch, False, use_con, use_adv)


# --- --resume ---------------------------------------------------------------


def test_resume_round_trip_is_bit_identical(models, batch, tmp_path):  # noqa: F811
    """2 steps, save, load in a fresh trainer, the third step: parameters,
    optimizer moments and memory equal an uninterrupted run's bit for bit."""
    import copy
    import logging

    _, _, tm = models
    images, labels, _ = batch
    feed = {"image": images, "label": labels}

    def fresh(resume=None):
        trainer = aux_trainer(copy.deepcopy(tm), use_contrastive_loss=True, use_adv_loss=True,
                              warmup_iter=2, seed=3)
        trainer.resume = resume
        trainer.logger = logging.getLogger("test_resume")
        trainer.epoch_train_outputs = []
        trainer.memory = init_feature_memory(CLASSES, 32)
        if resume is not None:
            trainer.load_state_dict(resume)
        return trainer

    straight = fresh()
    for _ in range(2):
        straight.train_step(feed)
    straight.save_state_dict(tmp_path / "ckpt", save_training_state=True)
    assert {p.name for p in (tmp_path / "ckpt").iterdir()} == {
        "lora.msgpack", "training_state.json", "training_state.pth"}
    straight.train_step(feed)  # the third step is a phase-2 step: prompts from the generator

    resumed = fresh(tmp_path / "ckpt")
    assert resumed.current_iter == 2 and resumed.current_epoch == 1
    assert resumed.optimizer.count == 2
    resumed.train_step(feed)
    assert resumed.current_iter == straight.current_iter == 3
    for (n, a), (_, b) in zip(straight.model.named_parameters(), resumed.model.named_parameters()):
        assert torch.equal(a, b), n
    for a, b in zip((*straight.optimizer.mu, *straight.optimizer.nu),
                    (*resumed.optimizer.mu, *resumed.optimizer.nu)):
        assert torch.equal(a, b)
    assert torch.equal(straight.memory.bank, resumed.memory.bank)
    assert torch.equal(straight.memory.valid, resumed.memory.valid)
    assert torch.equal(straight.generator.get_state(), resumed.generator.get_state())
    moved = [n for (n, a), (_, b) in zip(tm.named_parameters(), resumed.model.named_parameters())
             if not torch.equal(a, b)]
    assert any("lora_" in n for n in moved) and any(n.startswith("projection_head") for n in moved)
