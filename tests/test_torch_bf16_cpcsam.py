"""CPC-SAM training in bfloat16 against the JAX package's, on the narrow
``SamDualmask`` of ``test_torch_cpcsam.py`` (64², embed 32, depth 2, 2 heads,
block 1 global, LoRA rank 2), from the same seeded float32 weights.

The JAX references run the encoder on its TPU path, the port's default (the
Pallas LayerNorm + partition and packed attention kernels in interpret mode,
``fused="always"``, ``fuse_ln_window="always"``), and every JAX program is
compiled to round op by op (``jax_bf16.py``). The measure is the relative
Frobenius distance ``‖a − b‖ / ‖JAX float32‖``; each tolerance is stated
below with the reading measured here beside it. The block's and the loss's
lie under a tenth and a fifth of JAX's own bfloat16-vs-float32 gap on the
same inputs, asserted, and the port's float32 model misses them, so they
tell bfloat16 compute from float32 compute; the whole model's gradients are
held as :func:`check_bf16_losses` says, the decoder's module by module in
``test_torch_bf16_cpcsam_decoder.py``.

- One encoder block, windowed (its K4 → K2 path) and global (K3), forward and
  backward (the input's cotangent and the LoRA gradients), against flax's
  ``Block(dtype=bfloat16)``.
- The fixed-prompt phase-1 and phase-2 losses (the JAX trainer's composition,
  softmaxes of the logits in float32) with their LoRA and decoder gradients
  (held as :func:`check_bf16_losses` says).
- ``cpcsam_train_torch --compute-dtype bfloat16 --device cpu`` end to end;
  its ``lora.msgpack`` (float32, flax's layout) loads in the JAX package.
"""

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp

from mia_tpu.models.sam import SamDualmask as JaxSamDualmask
from mia_tpu.models.sam import image_encoder as jax_image_encoder
from mia_tpu.models.sam import sam as jax_sam
from mia_tpu.models.sam.image_encoder import ImageEncoderViT as JaxEncoder

import torch
from jax_bf16 import jit_op_by_op
from test_torch_cpcsam import BATCH, CLASSES, DICE_W, KW, LBS, SIZE, _seeded_params, _to_torch
from test_torch_cpcsam_train import NARROW, acdc_root  # noqa: F401

from mia_tpu_torch.models.sam import SamDualmask
from mia_tpu_torch.models.sam.image_encoder import Block
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax
from mia_tpu_torch.training.cpcsam_trainer import CPCSAMTrainer


def _rel(a, b, ref) -> float:
    a, b, ref = (np.asarray(t, np.float32).ravel() for t in (a, b, ref))
    return float(np.linalg.norm(a - b) / np.linalg.norm(ref))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _pallas_encoder(model):
    return JaxEncoder(img_size=model.img_size, patch_size=16, embed_dim=model.encoder_embed_dim,
                      depth=model.encoder_depth, num_heads=model.encoder_num_heads, out_chans=256,
                      use_rel_pos=True, window_size=14,
                      global_attn_indexes=model.encoder_global_attn_indexes,
                      lora_rank=model.lora_rank, dtype=model.dtype, fused="always",
                      fuse_ln_window="always")


def _layer_norm_once(x, scale, bias, eps, dtype):
    """flax's LayerNorm arithmetic (float32 statistics, fast variance, the
    output in ``dtype``) whose input cotangent is its float32 VJP rounded
    once to x's dtype."""

    def stats(xf):
        n = xf.shape[-1]
        mu = xf.sum(-1, keepdims=True) / n
        var = jnp.maximum((xf * xf).sum(-1, keepdims=True) / n - mu * mu, 0.0)
        return mu, jax.lax.rsqrt(var + eps)

    @jax.custom_vjp
    def ln(x, scale, bias):
        xf = x.astype(jnp.float32)
        mu, rstd = stats(xf)
        return ((xf - mu) * (rstd * scale) + bias).astype(dtype)

    def fwd(x, scale, bias):
        return ln(x, scale, bias), (x, scale)

    def bwd(res, g):
        x, scale = res
        xf, g = x.astype(jnp.float32), g.astype(jnp.float32)
        mu, rstd = stats(xf)
        xhat = (xf - mu) * rstd
        gw = g * scale
        dx = rstd * (gw - gw.mean(-1, keepdims=True) - xhat * (gw * xhat).mean(-1, keepdims=True))
        axes = tuple(range(x.ndim - 1))
        return dx.astype(x.dtype), (g * xhat).sum(axes), g.sum(axes)

    ln.defvjp(fwd, bwd)
    return ln(x, scale, bias)


class OnceRoundedLayerNorm(flax.linen.LayerNorm):
    """``flax.linen.LayerNorm`` with :func:`_layer_norm_once`'s VJP. XLA's CPU
    autodiff of flax's LayerNorm converts a bfloat16 input to float32 twice
    (statistics and normalisation), so its cotangent comes back as two
    bfloat16 roundings added in bfloat16; the port computes the VJP in
    float32 and rounds once (``test_bfloat16_module_vjps``). The JAX
    references below use this LayerNorm, so that they hold the port to the
    once-rounded gradient where JAX's CPU backward rounds three times."""

    @flax.linen.compact
    def __call__(self, x, *args, **kwargs):
        feat = x.shape[-1]
        scale = self.param("scale", self.scale_init, (feat,), self.param_dtype)
        bias = self.param("bias", self.bias_init, (feat,), self.param_dtype)
        dtype = self.dtype or jnp.result_type(x, scale, bias)
        return _layer_norm_once(x, scale, bias, self.epsilon, dtype)


# --- module VJPs ------------------------------------------------------------------------


def _vjp_f64_rounded(fn, x, g):
    """The VJP of ``fn`` at the bfloat16 ``x`` in float64, rounded once to bfloat16."""
    xd = torch.from_numpy(np.asarray(x, np.float64)).requires_grad_()
    (dx,) = torch.autograd.grad(fn(xd), xd, torch.from_numpy(np.asarray(g, np.float64)))
    return dx.to(torch.bfloat16)


@pytest.mark.parametrize("module", ["gelu", "layer_norm"])
def test_bfloat16_module_vjps(module):
    """The block's elementwise modules in bfloat16, forward and VJP on the
    same bfloat16 input and cotangent. GELU: flax's ``nn.gelu(approximate=
    False)`` and JAX's autodiff of it, op by op, bit for bit (the port
    rounds its constants where JAX does). LayerNorm: the port's VJP is the
    float64 VJP rounded once (one ulp, 99% bit-equal), and JAX's CPU VJP of
    flax's LayerNorm is not (it rounds the direct and the statistics paths
    apart, then adds them in bfloat16: 11-14 ulps, 65-66% bit-equal here);
    :class:`OnceRoundedLayerNorm` is."""
    from test_torch_bf16_kernels import _agreement

    from mia_tpu_torch.models.sam.common import LayerNorm, gelu

    rng = np.random.default_rng(11)
    x = jnp.asarray((rng.standard_normal((2, 10, 10, 32)) * 2).astype(np.float32), jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal((2, 10, 10, 32)).astype(np.float32), jnp.bfloat16)
    scale = jnp.asarray(1 + 0.2 * rng.standard_normal(32), jnp.float32)
    bias = jnp.asarray(0.1 * rng.standard_normal(32), jnp.float32)
    if module == "gelu":
        fns = {"flax": lambda v: flax.linen.gelu(v, approximate=False)}
        port = gelu
    else:
        fns = {"flax": lambda v: flax.linen.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16).apply(
                   {"params": {"scale": scale, "bias": bias}}, v),
               "once": lambda v: OnceRoundedLayerNorm(epsilon=1e-6, dtype=jnp.bfloat16).apply(
                   {"params": {"scale": scale, "bias": bias}}, v)}
        port = LayerNorm(32, 1e-6, torch.bfloat16)
        with torch.no_grad():
            port.weight.copy_(torch.from_numpy(np.array(scale)))
            port.bias.copy_(torch.from_numpy(np.array(bias)))
    want = {k: jit_op_by_op(lambda v, c, f=f: (lambda y, b: (y, b(c)[0]))(*jax.vjp(f, v)))(x, g)
            for k, f in fns.items()}
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).requires_grad_()
    y = port(xt)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(np.asarray(g, np.float32)).to(torch.bfloat16))
    assert y.dtype == dx.dtype == torch.bfloat16
    assert _agreement(y.detach(), want["flax"][0]) == (0.0, 1.0)
    if module == "gelu":
        assert _agreement(dx, want["flax"][1]) == (0.0, 1.0)
        return
    f64 = _vjp_f64_rounded(lambda v: _ln64(v, port), x, g).float().numpy()
    for got in (dx, torch.from_numpy(np.asarray(want["once"][1], np.float32))):
        ulps, equal = _agreement(got, f64)
        assert ulps <= 1.0 and equal >= 0.99, (ulps, equal)
    ulps, equal = _agreement(torch.from_numpy(np.asarray(want["flax"][1], np.float32)), f64)
    assert ulps > 1.0 and equal < 0.99, (ulps, equal)


def _ln64(v, port):
    from mia_tpu_torch.ops.ln_window import layer_norm

    return layer_norm(v, port.weight.detach().double(), port.bias.detach().double(), port.eps)


# --- one encoder block ------------------------------------------------------------------

BLOCK_DIM, BLOCK_HEADS, BLOCK_SIDE = 32, 2, 10


def _block_case(window: int):
    """A seeded flax block (LoRA 2, rel-pos tables, biases) and its input and
    cotangent: a 10x10 grid, windows of 4 (a padded grid) or global."""
    rng = np.random.default_rng(window + 3)
    kw = dict(dim=BLOCK_DIM, num_heads=BLOCK_HEADS, use_rel_pos=True, window_size=window,
              input_size=(BLOCK_SIDE, BLOCK_SIDE), lora_rank=2, fused="always",
              fuse_ln_window="always")
    x = (rng.standard_normal((2, BLOCK_SIDE, BLOCK_SIDE, BLOCK_DIM)) * 2.0).astype(np.float32)
    shapes = jax.eval_shape(jax_image_encoder.Block(**kw).init, jax.random.PRNGKey(0),
                            jnp.zeros(x.shape))
    params = _seeded_params(shapes["params"], rng)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return kw, params, x, g


def _jax_block(kw, params, x, g, dtype):
    """Output, input cotangent and parameter gradients of the flax block in
    ``dtype``, compiled op by op."""
    mdl = jax_image_encoder.Block(**kw, dtype=dtype)

    def run(p, x, g):
        y, vjp = jax.vjp(lambda p, x: mdl.apply({"params": p}, x), p, x)
        return (y, *vjp(g.astype(y.dtype)))

    xx = jnp.asarray(x, dtype)
    y, dp, dx = jit_op_by_op(run)(params, xx, jnp.asarray(g))
    return y, dx, dp


def _port_block(kw, params, x, g, dtype):
    block = Block(BLOCK_DIM, BLOCK_HEADS, kw["window_size"], (BLOCK_SIDE, BLOCK_SIDE),
                  lora_rank=2, compute_dtype=dtype)
    sd = sam_state_dict_from_flax({"params": {"image_encoder": {"block0": params}}})
    prefix = "image_encoder.blocks.0."
    block.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    y = block(xt)
    named = dict(block.named_parameters())
    lora = [n for n in named if "lora_" in n]
    grads = torch.autograd.grad(y, [xt] + [named[n] for n in lora], torch.from_numpy(g).to(dtype))
    return y, grads[0], dict(zip(lora, grads[1:]))


# measured: 0 / 0 / 0 windowed, 0 / 1.05e-4 / 1.74e-4 global, against gaps of 3.8-4.1e-3 /
# 5.3-5.4e-3 / 8.5-11.2e-3 (under a tenth of each)
BLOCK_TOL = {"out": 1e-4, "dx": 5e-4, "lora": 1e-3}


@pytest.mark.parametrize("window", [4, 0], ids=["windowed", "global"])
def test_bfloat16_block_forward_and_backward_match_jax(window):
    """The port's bfloat16 block (K4 → K2 windowed, K3 global, each with its
    bfloat16 backward) against flax's ``Block(dtype=bfloat16)`` with its
    LayerNorms' VJP rounded once (:class:`OnceRoundedLayerNorm`): the output,
    the input's cotangent and the LoRA gradients within ``BLOCK_TOL`` of JAX's
    bfloat16 block, under a tenth of JAX's own bfloat16-vs-float32 gap, which
    the port's float32 block misses. With flax's own LayerNorm VJP the
    windowed block's cotangent lies 0.78 of that gap away: all of it from
    JAX's CPU LayerNorm backward (every other module's VJP is bit-equal)."""
    kw, params, x, g = _block_case(window)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "LayerNorm", OnceRoundedLayerNorm)
        j16 = _jax_block(kw, params, x, g, jnp.bfloat16)
    j32 = _jax_block(kw, params, x, g, jnp.float32)
    p16 = _port_block(kw, params, x, g, torch.bfloat16)
    p32 = _port_block(kw, params, x, g, torch.float32)
    assert j16[0].dtype == jnp.bfloat16 and p16[0].dtype == p16[1].dtype == torch.bfloat16
    flat = {"out": 0, "dx": 1}
    for name, tol in BLOCK_TOL.items():
        if name == "lora":
            lora = {k: sam_state_dict_from_flax({"params": {"image_encoder": {"block0": v}}})
                    for k, v in (("16", j16[2]), ("32", j32[2]))}
            keys = sorted(p16[2])
            want16 = np.concatenate([_np(lora["16"]["image_encoder.blocks.0." + k]).ravel()
                                     for k in keys])
            want32 = np.concatenate([_np(lora["32"]["image_encoder.blocks.0." + k]).ravel()
                                     for k in keys])
            got16 = np.concatenate([_np(p16[2][k]).ravel() for k in keys])
            got32 = np.concatenate([_np(p32[2][k]).ravel() for k in keys])
        else:
            want16, want32 = _np(j16[flat[name]]), _np(j32[flat[name]])
            got16, got32 = _np(p16[flat[name]]), _np(p32[flat[name]])
        gap = _rel(want16, want32, want32)
        err = _rel(got16, want16, want32)
        assert tol < gap, (name, tol, gap)
        assert err <= tol, (name, err, tol)
        assert _rel(got32, want16, want32) > tol, name


# --- the narrow SamDualmask: fixed-prompt losses and gradients ---------------------------


@pytest.fixture(scope="module")
def bf16_models():
    """The seeded weights of ``test_torch_cpcsam.py``'s narrow model in the
    JAX ``SamDualmask(dtype=bfloat16)`` and float32, and in the port's
    bfloat16 and float32 models."""
    jm = JaxSamDualmask(**KW, use_stacked_decoders=False)
    x = jnp.zeros((1, SIZE, SIZE, 3))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: jm.init({"params": k, "prompt": k, "dropout": k}, x, SIZE,
                                              method=jm.init_variables), key)
    params = _seeded_params(shapes["params"], np.random.default_rng(0))
    port = {}
    for dtype in (torch.bfloat16, torch.float32):
        port[dtype] = SamDualmask(**KW, compute_dtype=dtype)
        port[dtype].load_state_dict(sam_state_dict_from_flax({"params": params}), strict=True)
    return params, port


def _jax_losses_bf16(params, images, labels, phase2, prompts, dtype):
    """The JAX trainer's loss composition in ``dtype`` (labeled-only loss1;
    phase 2's supervised and consistency terms, the pseudo-labels from
    float32 softmaxes of the logits) with injected prompts → (loss,
    gradients). bfloat16: the encoder on the Pallas path, the LayerNorms of
    :class:`OnceRoundedLayerNorm`, compiled op by op; float32: as the JAX
    trainer builds it on this backend."""
    from mia_tpu.losses import DiceAndCELoss as JaxDiceCE

    jm = JaxSamDualmask(**KW, dtype=dtype, use_stacked_decoders=False)
    sup = JaxDiceCE(dice_weight=DICE_W, ce_weight=1 - DICE_W, smooth=1e-5, do_bg=True)
    rngs = {"prompt": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)}

    def sup_w(logits, lbl, w):
        return sup(logits, lbl, dice_weight=w, ce_weight=1 - w)[0]

    def loss(p, x, y, prompts):
        emb = jm.apply({"params": p}, x if phase2 else x[:LBS], method=jm.get_image_embeddings)
        out = jm.apply({"params": p}, x[:LBS], True, SIZE, -1, None, emb[:LBS], train=True,
                       rngs=rngs)
        loss1 = sum(sup_w(out["low_res_logits"][i][:LBS], y[:LBS], DICE_W) for i in range(3))
        if not phase2:
            return loss1
        sup2 = sup2_r = cons2 = cons2_r = 0.0
        for k in range(3):
            out2 = jm.apply({"params": p}, x, True, SIZE, k, ["point"], emb, train=True,
                            prompts=prompts[k], rngs=rngs)
            lrl_p, lrl_pr = out2["low_res_logits"][k], out2["low_res_logits_r"][k]
            sup2 = sup2 + sup_w(lrl_p[:LBS], y[:LBS], DICE_W)
            sup2_r = sup2_r + sup_w(lrl_pr[:LBS], y[:LBS], DICE_W)
            ens = (jax.nn.softmax(lrl_p.astype(jnp.float32), -1)
                   + jax.nn.softmax(lrl_pr.astype(jnp.float32), -1)) / 2.0
            pseudo = jax.lax.stop_gradient(jnp.argmax(ens[LBS:], -1))
            for o in range(3):
                if o != k:
                    cons2 = cons2 + sup_w(out2["low_res_logits"][o][LBS:], pseudo, 0.5)
            cons2_r = cons2_r + sup_w(lrl_pr[LBS:], pseudo, 0.5)
        return loss1 + (sup2 + sup2_r + 0.4 * cons2 + 0.05 * cons2_r)

    args = (params, jnp.asarray(images), jnp.asarray(labels, jnp.int32),
            jax.tree.map(jnp.asarray, prompts))
    if dtype == jnp.float32:
        return jax.jit(jax.value_and_grad(loss))(*args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sam, "build_image_encoder", _pallas_encoder)
        mp.setattr(flax.linen, "LayerNorm", OnceRoundedLayerNorm)
        return jit_op_by_op(jax.value_and_grad(loss))(*args)


def _port_losses(model, images, labels, phase2, prompts):
    trainer = CPCSAMTrainer(device="cpu", config=dict(
        image_size=SIZE, num_classes=CLASSES, batch_size=BATCH, labeled_batch_ratio=0.5,
        lora_rank=2, dice_weight=DICE_W, promptmode=["point"], optimizer_name="adam",
        compute_dtype="bfloat16"))
    trainer.model = model
    trainer._setup_loss()
    trainer._setup_optimizer()
    total = trainer.compute_losses(torch.from_numpy(images), torch.from_numpy(labels), 0, phase2,
                                   prompts=[_to_torch(p) for p in prompts] if phase2 else None)[0]
    named = dict(model.named_parameters())
    names = [n for n, p in named.items() if p.requires_grad]
    grads = torch.autograd.grad(total, [named[n] for n in names], allow_unused=True)
    return total.item(), {n: g for n, g in zip(names, grads) if g is not None}


def _groups(grads):
    """Gradient groups: the LoRA adapters, the decoders' weights and their
    biases (each concatenated)."""
    keys = sorted(grads)
    return {
        "lora": [k for k in keys if "lora_" in k],
        "decoder weights": [k for k in keys if k.startswith("mask_decoder") and not k.endswith("bias")],
        "decoder biases": [k for k in keys if k.startswith("mask_decoder") and k.endswith("bias")],
    }


# |port − JAX bfloat16| / |JAX bfloat16 − JAX float32| of the total loss (measured 0.057 in
# phase 1, 0.037 in phase 2; the port's float32 model reads 1.00 in both)
LOSS_SHARE = 0.2
# per gradient group: ‖port bfloat16 − JAX float32‖ ≤ share · ‖JAX bfloat16 − JAX float32‖
# (measured, phase 1 / phase 2: LoRA 0.91 / 1.47, decoder weights 1.18 / 1.31, decoder
# biases 0.13 / 0.08)
GRAD_SHARE = {"lora": 1.6, "decoder weights": 1.5, "decoder biases": 0.3}
# ‖port bfloat16 − port float32‖ / ‖JAX float32‖ of every group: the port's bfloat16
# gradients are bfloat16 ones (its float32 gradients lie within 1.1e-4 of JAX's)
BF16_FLOOR = 1e-3
F32_TOL = 1e-3  # ‖port float32 − JAX float32‖ / ‖JAX float32‖: the same program


def check_bf16_losses(bf16_models, batch, phase2):  # noqa: F811
    """The bfloat16 trainer's fixed-prompt loss and its LoRA and decoder
    gradients against JAX's bfloat16 composition (``_jax_losses_bf16``).

    The loss lies within ``LOSS_SHARE`` of JAX's own bfloat16-vs-float32
    gap from JAX's bfloat16 loss, which the port's float32 loss misses.

    The whole model's gradients cannot be held that close: one-ulp flips
    (float32 sums in another order round one output in ~2000 the other way,
    ``test_torch_bf16_sam.py``) compound through the forward and, in the
    decoders' attentions, through query and key gradients that cancel
    (``test_torch_bf16_cpcsam_decoder.py``). An equally valid bfloat16 port,
    its Linears summed in float64 before their one rounding, lies 0.56 /
    0.28 (LoRA), 1.15 / 0.48 (decoder weights) and 0.12 / 0.05 (decoder
    biases) of JAX's gap from this one in phase 1 / 2 (measured here), and the
    port lies 0.51 / 1.37, 1.11 / 1.13 of the gap from JAX's bfloat16 LoRA
    and decoder weight gradients. JAX's decoder bias gradients sit a whole
    gap away (XLA's CPU backward sums a bfloat16 bias cotangent in
    bfloat16), the port's 0.13 / 0.08. The roundings themselves are held
    module by module: ``test_bfloat16_module_vjps``,
    ``test_bfloat16_block_forward_and_backward_match_jax``,
    ``test_torch_bf16_backward.py`` and ``test_torch_bf16_cpcsam_decoder.py``
    (every decoder module, the biases against their float64 gradient rounded
    once). Here each gradient group lies no farther from JAX's float32
    gradient than ``GRAD_SHARE`` times JAX's own bfloat16 one (just above
    the measured shares: a halved or zeroed group misses by far), and at
    least ``BF16_FLOOR`` from the port's float32 gradient, which itself lies
    within ``F32_TOL`` of JAX's float32 one."""
    params, port = bf16_models
    images, labels, prompts = batch
    jax16 = _jax_losses_bf16(params, images, labels, phase2, prompts, jnp.bfloat16)
    jax32 = _jax_losses_bf16(params, images, labels, phase2, prompts, jnp.float32)
    got16 = _port_losses(port[torch.bfloat16], images, labels, phase2, prompts)
    got32 = _port_losses(port[torch.float32], images, labels, phase2, prompts)
    want16, want32 = (sam_state_dict_from_flax({"params": jax.device_get(g)})
                      for _, g in (jax16, jax32))
    loss_gap = abs(float(jax16[0]) - float(jax32[0]))
    assert np.isfinite(got16[0]) and abs(got16[0] - float(jax16[0])) <= LOSS_SHARE * loss_gap
    assert abs(got32[0] - float(jax16[0])) > LOSS_SHARE * loss_gap
    groups = _groups(got16[1])
    assert len(groups["lora"]) == 8 and groups["decoder weights"] and groups["decoder biases"]
    assert set(got16[1]) == set(got32[1]) and set(groups["lora"]) <= set(want16)
    for name, keys in groups.items():
        def cat(grads):
            return np.concatenate([_np(grads[k]).ravel() for k in keys])

        jax_gap = _rel(cat(want16), cat(want32), cat(want32))
        port_to_f32 = _rel(cat(got16[1]), cat(want32), cat(want32))
        assert port_to_f32 <= GRAD_SHARE[name] * jax_gap, (name, port_to_f32, jax_gap)
        assert _rel(cat(got16[1]), cat(got32[1]), cat(want32)) >= BF16_FLOOR, name
        assert _rel(cat(got32[1]), cat(want32), cat(want32)) <= F32_TOL, name


# --- the entry point -----------------------------------------------------------------------


def test_cpcsam_train_bfloat16_entry_on_cpu(acdc_root, tmp_path, monkeypatch):  # noqa: F811
    """``cpcsam_train_torch --compute-dtype bfloat16 --device cpu`` on the
    synthetic ACDC set with a narrow encoder: 2 phase-1 and 2 phase-2 steps,
    a validation and the real test of the bfloat16 model; float32
    parameters, finite losses, the LoRA tensors moved and the frozen encoder
    bit-identical. Its ``lora.msgpack`` is float32 in flax's layout: the JAX
    package's reader loads it into a ``SamDualmask``'s parameters, bit for
    bit; and the port resumes its ``final_model`` for one more step."""
    from mia_tpu.models.sam.lora import load_lora_bytes

    from mia_tpu_torch.entry.cpcsam.train import train_entry
    from mia_tpu_torch.models.sam import build_sam
    from mia_tpu_torch.models.sam.lora import lora_state_dict, read_lora_checkpoint
    from mia_tpu_torch.training import cpcsam_trainer

    root = acdc_root
    monkeypatch.setitem(build_sam._VIT_SPECS, "vit_b", NARROW)
    monkeypatch.setitem(cpcsam_trainer.PATIENTS_TO_SLICES["ACDC"], "1", 4)
    snap, losses = {}, []

    class Recording(cpcsam_trainer.CPCSAMTrainer):
        def on_train_start(self):
            super().on_train_start()
            snap.update({n: p.detach().clone() for n, p in self.model.named_parameters()})

        def _log_train(self, step, lr, step_losses):
            losses.append([float(v) for v in step_losses])
            return super()._log_train(step, lr, step_losses)

    monkeypatch.setattr(cpcsam_trainer, "CPCSAMTrainer", Recording)
    common = ["--data-path", str(root), "--device", "cpu", "--image-size", "64", "--batch-size",
              "4", "--lora-rank", "2", "--quiet", "--compute-dtype", "bfloat16",
              "--lr-warmup-iter", "1", "--warmup-iter", "2"]
    trainer = train_entry(common + ["--work-path", str(tmp_path / "run"), "--min-iter", "4",
                                    "--max-iter", "4", "--valid-freq-iter", "4"])
    model, work = trainer.model, trainer.work_path
    assert model.image_encoder.compute_dtype == torch.bfloat16
    assert all(d.compute_dtype == torch.bfloat16 for d in model.mask_decoders)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert len(losses) == 4 and all(np.isfinite(v) for row in losses for v in row)
    assert [row[2] > 0 for row in losses] == [False, False, True, True]
    log = (work / "log.txt").read_text()
    assert log.count("Valid results") == 1 and "Real test results" in log
    for n, p in model.named_parameters():
        moved = not torch.equal(p.detach(), snap[n])
        assert moved if "lora_" in n else not (n.startswith("image_encoder.") and moved), n

    data = (work / "final_model" / "lora.msgpack").read_bytes()
    jm = JaxSamDualmask(**KW, use_stacked_decoders=False)
    shapes = jax.eval_shape(lambda k: jm.init({"params": k, "prompt": k, "dropout": k},
                                              jnp.zeros((1, SIZE, SIZE, 3)), SIZE,
                                              method=jm.init_variables), jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes["params"])
    loaded = sam_state_dict_from_flax({"params": load_lora_bytes(zeros, data)})
    held = lora_state_dict(model)
    assert all(v.dtype == torch.float32 for v in read_lora_checkpoint(
        work / "final_model" / "lora.msgpack").values())
    assert len(held) > 8 and all(torch.equal(loaded[k], v) for k, v in held.items())

    resumed = train_entry(common + ["--work-path", str(tmp_path / "resumed"), "--min-iter", "5",
                                    "--max-iter", "5", "--valid-freq-iter", "100",
                                    "--resume", str(work / "final_model")])
    assert resumed.current_iter == 5 and resumed.optimizer.count == 5
    assert len(losses) == 5 and np.isfinite(losses[-1]).all()
