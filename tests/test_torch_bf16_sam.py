"""SAM serving in bfloat16 against the JAX ``Sam(dtype=jnp.bfloat16)``, from
the same float32 weights (carried over by ``sam_state_dict_from_flax``), and
the registry building the bfloat16 model; and the guards of what is not
ported in bfloat16.

A narrow SAM (2 blocks, the second global; the window-14 block attends over
one padded window) runs ``set_image`` and ``predict``. The JAX encoder runs
its TPU path, the port's default (the Pallas LayerNorm + partition and packed
attention kernels, in interpret mode), and every JAX program is compiled to
round op by op (``jax_bf16.py``). Both then round in bfloat16 at the same
operations; the encoder agrees to ~6e-5 of its norm. The decoder is held
module by module on JAX's own inputs (every module within one bfloat16 ulp
of JAX's output, 99% bit-equal; ``test_decoder_modules_match_jax_bfloat16``).
Whole, it departs further: a Linear's float32 sum in another order rounds
about one output in 2000 the other way (the first self-attention's k_proj,
1.9e-4 of its norm), and each attention carries such a flip into every score
of its row. On JAX's own bfloat16 embedding the port's decoder then lies
0.78-0.94 of JAX's bfloat16-vs-float32 gap from JAX's bfloat16 logits, and
0.79-0.97 from its own embedding (measured on these inputs): the whole-model
tolerances below hold that bound, the module test holds the roundings. The
measure is the relative Frobenius norm ``‖a − b‖ / ‖JAX float32‖``; each
tolerance is stated, asserted below JAX's own bfloat16-vs-float32 gap on the
same inputs, and missed by the port's float32 model. The iou, a handful of
values in [0, 1] whose bfloat16 step is 2^-8, moves by less than a step
between JAX's bfloat16 and float32 models; it is held to two steps.
"""

import re

import numpy as np
import pytest

import flax.linen as nn
import jax
import jax.numpy as jnp

from mia_tpu.models.sam import ImageEncoderViT as JaxEncoder
from mia_tpu.models.sam import Sam as JaxSam
from mia_tpu.models.sam import SamPredictor as JaxPredictor
from mia_tpu.models.sam import predictor as jax_predictor
from mia_tpu.models.sam import sam as jax_sam

import torch
from jax_bf16 import OpByOpJax

from mia_tpu_torch.models.sam import ImageEncoderViT, Sam, SamPredictor, build_sam
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax

SAM_KW = dict(img_size=64, num_classes=3, encoder_embed_dim=32, encoder_depth=2,
              encoder_num_heads=2, encoder_global_attn_indexes=(1,))
EMB_TOL = 1e-3  # set_image embedding
# predict's mask logits at the original size, by prompt
LOGIT_TOL = {"point": 9e-3, "box": 8.5e-3, "point_box_mask": 1.2e-2}
IOU_TOL = 2.0 ** -7  # two bfloat16 steps of an iou in [0.5, 1)


def _rel(a, b, ref) -> float:
    a, b, ref = (np.asarray(t, np.float32) for t in (a, b, ref))
    return float(np.linalg.norm(a - b) / np.linalg.norm(ref))


def _randomize(params, rng, names=("rel_pos_h", "rel_pos_w", "pos_embed")):
    return {
        k: _randomize(v, rng, names) if isinstance(v, dict)
        else (rng.standard_normal(v.shape).astype(np.float32) * 0.1 if k in names else v)
        for k, v in params.items()
    }


def _pallas_encoder(model):
    """The JAX encoder on its TPU path, the port's default: LayerNorm +
    partition and the packed attention as the Pallas kernels (interpret mode
    here, as the JAX package's own tests run them)."""
    return JaxEncoder(img_size=model.img_size, patch_size=16, embed_dim=model.encoder_embed_dim,
                      depth=model.encoder_depth, num_heads=model.encoder_num_heads, out_chans=256,
                      use_rel_pos=True, window_size=14,
                      global_attn_indexes=model.encoder_global_attn_indexes,
                      lora_rank=model.lora_rank, dtype=model.dtype, fused="always",
                      fuse_ln_window="always")


@pytest.fixture(scope="module")
def predictors():
    """JAX predictors of the float32 and bfloat16 models (the encoder on the
    Pallas path, every program compiled to round op by op) and the port's,
    all on one image."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sam, "build_image_encoder", _pallas_encoder)
        mp.setattr(jax_predictor, "jax", OpByOpJax())
        yield _predictors()


def _predictors():
    rng = np.random.default_rng(0)
    jm32, jm16 = JaxSam(**SAM_KW), JaxSam(**SAM_KW, dtype=jnp.bfloat16)

    def init_all(mdl, x):
        mdl.prompt_encoder(masks=jnp.zeros((1, 16, 16, 1)))
        return mdl.forward_train(x, True, 64)

    variables = jax.jit(lambda key, x: jm32.init(key, x, method=init_all))(
        jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)))
    variables = {"params": _randomize(jax.device_get(variables["params"]), rng)}
    sd = sam_state_dict_from_flax(variables)
    image = (np.random.default_rng(1).random((48, 64, 3)) * 255).astype(np.uint8)
    out = {}
    for key, model in (("jax32", JaxPredictor(jm32, variables, max_points=4)),
                       ("jax16", JaxPredictor(jm16, variables, max_points=4))):
        model.set_image(image)
        out[key] = model
    for key, dtype in (("port16", torch.bfloat16), ("port32", torch.float32)):
        tm = Sam(**SAM_KW, compute_dtype=dtype)
        tm.load_state_dict(sd, strict=True)
        out[key] = SamPredictor(tm, max_points=4)
        out[key].set_image(image)
    return out


def test_set_image_embedding_matches_jax_bfloat16(predictors):
    emb = {k: p.get_image_embedding() for k, p in predictors.items()}
    assert emb["jax16"].dtype == jnp.bfloat16 and emb["port16"].dtype == torch.bfloat16
    want16, want32 = np.asarray(emb["jax16"], np.float32), np.asarray(emb["jax32"])
    gap = _rel(want16, want32, want32)
    assert EMB_TOL < gap, (EMB_TOL, gap)
    assert _rel(emb["port16"].float().numpy(), want16, want32) <= EMB_TOL
    assert _rel(emb["port32"].numpy(), want16, want32) > EMB_TOL


PROMPTS = {
    "point": dict(point_coords=np.array([[30.0, 22.0]]), point_labels=np.array([1])),
    "box": dict(box=np.array([5.0, 4.0, 50.0, 40.0])),
    "point_box_mask": dict(point_coords=np.array([[30.0, 22.0]]), point_labels=np.array([1]),
                           box=np.array([5.0, 4.0, 50.0, 40.0]),
                           mask_input=np.random.default_rng(4).standard_normal((16, 16))),
}


ULP_FLOOR = 2.0 ** -6  # an element's ulp is taken at no less than this share of max |JAX|
MIN_EQUAL = 0.99  # share of a decoder module's outputs bit-equal to JAX's


def _agreement(got: torch.Tensor, want) -> tuple[float, float]:
    """(largest distance in bfloat16 ulps of ``want``, share bit-equal)."""
    want = np.asarray(want, np.float32)
    diff = np.abs(got.float().numpy() - want)
    floor = max(float(np.abs(want).max()) * ULP_FLOOR, 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), floor))) - 7)
    return float((diff / ulp).max()), float((diff == 0).mean())


def _port_module_name(path) -> str:
    """A flax module path of JAX's mask decoder → the port's module name."""
    name = "/".join(path[1:])
    for pattern, repl in ((r"^core/", ""), (r"hyper_mlp(\d+)", r"output_hypernetworks_mlps/\1"),
                          (r"iou_head", "iou_prediction_head"), (r"layers?_?(\d+)", r"layers/\1"),
                          (r"output_upscaling/up0", "output_upscaling/0"),
                          (r"output_upscaling/norm0", "output_upscaling/1"),
                          (r"output_upscaling/up1", "output_upscaling/3")):
        name = re.sub(pattern, repl, name)
    return name.replace("/", ".")


def _torch(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(dtype or (torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32))


def test_decoder_modules_match_jax_bfloat16(predictors, monkeypatch):
    """The decoder module by module on JAX's own inputs: each flax module
    call of JAX's bfloat16 decoder (one point, eager, so op by op) is
    replayed on the port's module of the same name. Every Linear, MLP,
    LayerNorm, upscaler stage and the upscaler lands within one bfloat16
    ulp of JAX's output and at least 99% bit-equal; so does every
    attention, given JAX's own q, k and v projections (a projection alone
    may round one element in ~2000 the other way: float32 sums in another
    order; inside the attention such a flip moves every score of its row,
    which is what carries the whole decoder 0.8-0.9 of JAX's
    bfloat16-vs-float32 gap away from JAX in the predict tests). The
    port's float32 modules miss this on the same inputs, bar the
    LayerNorms, which compute in float32 in both."""
    jax_pred = predictors["jax16"]
    # the decoder's biases and norm scales made non-zero: where a bias is
    # added is part of the rounding
    rng = np.random.default_rng(6)
    variables = {"params": {
        **jax_pred.variables["params"],
        "mask_decoder": _randomize(jax_pred.variables["params"]["mask_decoder"], rng,
                                   names=("bias", "scale"))}}
    port = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = Sam(**SAM_KW, compute_dtype=dtype)
        model.load_state_dict(sam_state_dict_from_flax(variables), strict=True)
        port[dtype] = dict(model.mask_decoder.named_modules())
    port16, port32 = port[torch.bfloat16], port[torch.float32]
    calls = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and context.module.path[:1] == ("mask_decoder",):
            calls.append((context.module.path, args, out))
        return out

    def decode(mdl):
        sparse, dense = mdl.prompt_encoder(points=(jnp.array([[[30.0, 22.0]]]),
                                                   jnp.ones((1, 1), jnp.int32)))
        return mdl.mask_decoder(jax_pred.features, mdl.prompt_encoder.get_dense_pe(), sparse,
                                dense, True)

    with nn.intercept_methods(record):
        jax_pred.model.apply(variables, method=decode)
    checked = set()
    for i, (path, args, want) in enumerate(calls):
        name = _port_module_name(path)
        if not isinstance(want, jax.Array) or not all(isinstance(a, jax.Array) for a in args):
            continue  # the decoder and the two-way transformer and its blocks: tuples
        assert want.dtype == jnp.bfloat16, name
        got = {}
        for dtype, modules in ((None, port16), (torch.float32, port32)):
            module = modules[name]
            with monkeypatch.context() as mp:
                if type(module).__name__ == "Attention":  # on JAX's projections
                    for p, _, proj in calls[:i]:
                        if p[:-1] == path and p[-1] in ("q_proj", "k_proj", "v_proj"):
                            mp.setattr(getattr(module, p[-1]), "forward",
                                       lambda x, proj=proj, dtype=dtype: _torch(proj, dtype))
                with torch.inference_mode():
                    got[dtype] = module(*(_torch(a, dtype) for a in args))
        assert got[None].dtype == torch.bfloat16, name
        ulps, equal = _agreement(got[None], want)
        assert ulps <= 1.0 and equal >= MIN_EQUAL, (name, ulps, equal)
        if type(port16[name]).__name__ not in ("LayerNorm", "LayerNorm2d"):
            ulps, equal = _agreement(got[torch.float32].to(torch.bfloat16), want)
            assert ulps > 1.0 or equal < MIN_EQUAL, (name, ulps, equal)
        checked.add(type(port16[name]).__name__)
    assert checked == {"Linear", "Attention", "LayerNorm", "MLPReLU", "MLP",
                       "EinsumConvTranspose2x", "LayerNorm2d", "_Upscaler"}, checked


@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_predict_matches_jax_bfloat16(predictors, prompt):
    kwargs = PROMPTS[prompt]
    logits = {k: p.predict(**kwargs, return_logits=True) for k, p in predictors.items()}
    want16, want_iou16, _ = (np.asarray(a, np.float32) for a in logits["jax16"])
    want32, want_iou32, _ = logits["jax32"]
    got, got_iou, got_low = logits["port16"]
    assert got.dtype == np.float32 and got.shape == want16.shape
    tol, gap = LOGIT_TOL[prompt], _rel(want16, want32, want32)
    assert tol < gap, (tol, gap)
    assert _rel(got, want16, want32) <= tol
    assert _rel(logits["port32"][0], want16, want32) > tol
    assert np.abs(got_iou - want_iou16).max() <= IOU_TOL
    # the thresholded masks: equal wherever the JAX logit clears the noise
    masks, _, low = predictors["port16"].predict(**kwargs)
    j_masks = predictors["jax16"].predict(**kwargs)[0]
    clear = np.abs(want16) > 4 * tol * np.abs(want16).max()
    assert masks.dtype == bool and np.array_equal(masks[clear], j_masks[clear])
    assert clear.mean() > 0.8
    assert low.dtype == np.float32 and np.array_equal(low, got_low)


def test_registry_builds_bfloat16_models(monkeypatch):
    """``sam_model_registry[name](..., compute_dtype=...)`` reaches the model
    (a torch dtype or its name), as the JAX registry's ``compute_dtype``."""
    monkeypatch.setitem(build_sam._VIT_SPECS, "vit_b",
                        dict(embed_dim=32, depth=2, num_heads=2, global_idx=(1,)))
    for dtype in (torch.bfloat16, "bfloat16"):
        tm, side = build_sam.sam_model_registry["vit_b"](64, 3, compute_dtype=dtype)
        assert side == 4 and tm.compute_dtype == torch.bfloat16
        assert tm.image_encoder.blocks[0].attn.qkv.compute_dtype == torch.bfloat16
        assert tm.mask_decoder.compute_dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        with torch.inference_mode():
            emb = tm.get_image_embeddings(torch.zeros(1, 64, 64, 3))
        assert emb.dtype == torch.bfloat16
    dual, _ = build_sam.sam_model_registry["vit_b_dualmask_same_prompt_class_random_large"](
        64, 3, compute_dtype=torch.bfloat16)
    assert dual.image_encoder.compute_dtype == torch.bfloat16
    assert all(d.compute_dtype == torch.bfloat16 for d in dual.mask_decoders)
    default, _ = build_sam.sam_model_registry["vit_b"](64, 3)
    assert default.compute_dtype == torch.float32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        build_sam.sam_model_registry["vit_b"](64, 3, compute_dtype=torch.float16)


ENC_KW = dict(img_size=40, patch_size=4, embed_dim=32, depth=2, num_heads=2, window_size=4,
              global_attn_indexes=(1,), compute_dtype=torch.bfloat16)


@pytest.mark.parametrize("options", [dict(attn_route="head_major"),
                                     dict(attn_route="grid_native", fuse_ln_window="never"),
                                     dict(use_rel_pos=False),
                                     dict(fuse_unpart_residual="always")])
def test_other_encoder_routes_raise_in_bfloat16(options):
    with pytest.raises(NotImplementedError, match="float32"):
        ImageEncoderViT(**ENC_KW, **options)


def test_windowed_attention_switch_raises_in_bfloat16(monkeypatch):
    """``MIA_WINDOWED_ATTN=1`` picks K8 at call time in an encoder without K4;
    in bfloat16 that raises instead of running the float32 kernel."""
    enc = ImageEncoderViT(**ENC_KW, fuse_ln_window="never")
    x = torch.zeros(1, 40, 40, 3)
    with torch.inference_mode():
        assert enc(x).dtype == torch.bfloat16  # the packed route: K2 after a plain partition
        monkeypatch.setenv("MIA_WINDOWED_ATTN", "1")
        with pytest.raises(NotImplementedError, match="K8"):
            enc(x)


def test_serving_then_training_in_one_process():
    """The rel-pos index and resize caches hand out normal tensors even when
    first filled under ``torch.inference_mode`` (as ``set_image`` runs): a
    training forward in the same process saves them for backward."""
    from mia_tpu_torch.models.sam import image_encoder
    from mia_tpu_torch.ops import resize

    image_encoder._rel_pos_index.cache_clear()
    resize._device_matrix.cache_clear()
    kw = {**ENC_KW, "compute_dtype": torch.float32}
    enc = ImageEncoderViT(**kw)
    with torch.inference_mode():
        enc(torch.zeros(1, 40, 40, 3))
        resize.resize(torch.zeros(1, 8, 8, 1), (16, 16))
    x = torch.rand(1, 8, 8, 1, requires_grad=True)
    (enc(torch.rand(1, 40, 40, 3)).sum() + resize.resize(x, (16, 16)).sum()).backward()
    assert x.grad is not None
    assert all(p.grad is not None for p in enc.parameters() if p.requires_grad)
