"""SAM models (counterpart of ``mia_tpu/models/sam/sam.py``): the plain
single-decoder ``Sam``, CPC-SAM's multi-decoder ``SamDualmask`` with its
feature heads, ``preprocess_image`` and ``postprocess_masks``.
Channel-last."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize
from .image_encoder import ImageEncoderViT
from .mask_decoder import MaskDecoder, MaskDecoderPromptLarge
from .prompt_encoder import PromptEncoder, PromptEncoderPromptClass
from .prompt_generation import prompt_generate_random_fast
from .transformer import TwoWayTransformer

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def preprocess_image(x: torch.Tensor, img_size: int, pixel_mean=PIXEL_MEAN,
                     pixel_std=PIXEL_STD) -> torch.Tensor:
    """Normalise and zero-pad ``(B, H, W, 3)`` to the encoder size."""
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=x.device)
    x = (x.to(torch.float32) - mean) / std
    h, w = x.shape[1], x.shape[2]
    return F.pad(x, (0, 0, 0, img_size - w, 0, img_size - h))


def postprocess_masks(masks: torch.Tensor, encoder_size: int, input_size,
                      original_size) -> torch.Tensor:
    """Upscale decoder masks to the encoder size, strip the padding, resize
    to the original size (plain bilinear). Channel-last."""
    masks = resize(masks, (encoder_size, encoder_size), "bilinear", antialias=False)
    masks = masks[:, : input_size[0], : input_size[1]]
    return resize(masks, tuple(original_size), "bilinear", antialias=False)


class Sam(nn.Module):
    """ViT image encoder, prompt encoder and one mask decoder; serving runs
    them through :class:`SamPredictor`. ``compute_dtype`` is the JAX
    ``Sam.dtype``: the encoder, the two-way transformer and the mask decoder
    compute in it over float32 parameters; the prompt encoder stays float32."""

    def __init__(self, img_size: int = 512, num_classes: int = 3, encoder_embed_dim: int = 768,
                 encoder_depth: int = 12, encoder_num_heads: int = 12,
                 encoder_global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11),
                 lora_rank: int = 0, mask_threshold: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        embed_dim, patch = 256, 16
        self.img_size = img_size
        self.mask_threshold = mask_threshold
        self.compute_dtype = compute_dtype
        self.image_encoder = ImageEncoderViT(
            img_size=img_size, patch_size=patch, embed_dim=encoder_embed_dim,
            depth=encoder_depth, num_heads=encoder_num_heads, out_chans=embed_dim,
            window_size=14, global_attn_indexes=tuple(encoder_global_attn_indexes),
            lora_rank=lora_rank, compute_dtype=compute_dtype,
        )
        side = img_size // patch
        self.prompt_encoder = PromptEncoder(
            embed_dim=embed_dim, image_embedding_size=(side, side),
            input_image_size=(img_size, img_size), mask_in_chans=16,
        )
        self.mask_decoder = MaskDecoder(
            transformer_dim=embed_dim,
            transformer=TwoWayTransformer(depth=2, embedding_dim=embed_dim, num_heads=8,
                                          mlp_dim=2048, compute_dtype=compute_dtype),
            num_multimask_outputs=num_classes,
            compute_dtype=compute_dtype,
        )

    def get_image_embeddings(self, batched_input: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` pixels (H, W ≤ img_size) → ``(B, S, S, 256)``."""
        return self.image_encoder(preprocess_image(batched_input, self.img_size))


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over a masked feature set: batch statistics (biased
    variance) from the rows where ``mask`` is true, or all rows."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, mask=None):
        if mask is None:
            mean = x.mean(0)
            var = x.var(0, unbiased=False)
        else:
            m = mask.to(torch.float32)[:, None]
            count = m.sum().clamp_min(1.0)
            mean = (x * m).sum(0) / count
            var = ((x - mean).square() * m).sum(0) / count
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class FeatureHead(nn.Module):
    """Linear → masked BN → ReLU (or leaky ReLU 0.2) → Linear: the
    projection, prediction and class-selector heads of the contrastive loss.
    They compute in float32 whatever the model's ``compute_dtype``: flax's
    ``Dense`` without a ``dtype`` promotes a bfloat16 input to its float32
    parameters."""

    def __init__(self, in_dim: int, hidden: int, out: int, act: str = "relu"):
        super().__init__()
        self.act = act
        self.lin1 = nn.Linear(in_dim, hidden)
        self.bn = MaskedBatchNorm(hidden)
        self.lin2 = nn.Linear(hidden, out)

    def forward(self, x, mask=None):
        x = self.bn(self.lin1(x.to(self.lin1.weight.dtype)), mask)
        x = torch.relu(x) if self.act == "relu" else F.leaky_relu(x, 0.2)
        return self.lin2(x)


class SamDualmask(nn.Module):
    """Multi-decoder CPC-SAM: a (LoRA-tuned) ViT encoder, the class-indexed
    prompt encoder, ``num_decoders`` ``MaskDecoderPromptLarge`` decoders
    (``mask_decoder{i}``) and the contrastive feature heads (read by the
    trainer's contrastive loss; always parameters, as in the checkpoint).

    The JAX package vmaps the unprompted decoders over stacked parameters;
    that is TPU scheduling, and here they run as a loop. ``compute_dtype``
    reaches the encoder and the decoders as in ``Sam``, and both passes
    train in it (in bfloat16 through the bfloat16 instances of K2b, K3b and
    K4b); the prompt encoder and the feature heads stay float32.
    """

    def __init__(self, img_size: int = 512, num_classes: int = 3, num_decoders: int = 3,
                 encoder_embed_dim: int = 768, encoder_depth: int = 12, encoder_num_heads: int = 12,
                 encoder_global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11),
                 dropout_rate: float = 0.0, num_points_prompt=(1, 2),
                 bbox_change_rate=(0.1, 0.2), lora_rank: int = 0, mask_threshold: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        embed_dim, patch = 256, 16
        self.img_size = img_size
        self.num_classes = num_classes
        self.num_decoders = num_decoders
        self.encoder_depth = encoder_depth
        self.encoder_global_attn_indexes = tuple(encoder_global_attn_indexes)
        self.dropout_rate = dropout_rate
        self.num_points_prompt = tuple(num_points_prompt)
        self.bbox_change_rate = tuple(bbox_change_rate)
        self.mask_threshold = mask_threshold
        self.image_encoder = ImageEncoderViT(
            img_size=img_size, patch_size=patch, embed_dim=encoder_embed_dim,
            depth=encoder_depth, num_heads=encoder_num_heads, out_chans=embed_dim,
            window_size=14, global_attn_indexes=self.encoder_global_attn_indexes,
            lora_rank=lora_rank, compute_dtype=compute_dtype,
        )
        self.embedding_size = img_size // patch
        self.prompt_encoder = PromptEncoderPromptClass(
            embed_dim=embed_dim, image_embedding_size=(self.embedding_size,) * 2,
            input_image_size=(img_size, img_size), mask_in_chans=16,
        )
        for i in range(num_decoders):
            self.add_module(f"mask_decoder{i}", MaskDecoderPromptLarge(
                transformer_dim=embed_dim,
                transformer=TwoWayTransformer(depth=2, embedding_dim=embed_dim, num_heads=8,
                                              mlp_dim=2048, compute_dtype=compute_dtype),
                num_multimask_outputs=num_classes,
                compute_dtype=compute_dtype,
            ))
        dim_in = embed_dim // 16  # dense-feature channels
        feat_dim = 2 * dim_in
        self.projection_head = FeatureHead(dim_in, feat_dim, feat_dim, "relu")
        self.prediction_head = FeatureHead(feat_dim, feat_dim, feat_dim, "relu")
        for c in range(num_classes + 1):
            self.add_module(f"contrastive_class_selector_{c}",
                            FeatureHead(feat_dim, feat_dim, 1, "leaky"))
            self.add_module(f"contrastive_class_selector_memory{c}",
                            FeatureHead(feat_dim, feat_dim, 1, "leaky"))

    @property
    def mask_decoders(self):
        return [getattr(self, f"mask_decoder{i}") for i in range(self.num_decoders)]

    # -- heads (read by the trainer's contrastive loss) ---------------------
    def project_features(self, features, mask=None):
        return self.projection_head(features, mask)

    def predict_features(self, features, mask=None):
        return self.prediction_head(features, mask)

    def select_features(self, c: int, features, mask=None, memory: bool = False):
        name = f"contrastive_class_selector_memory{c}" if memory else f"contrastive_class_selector_{c}"
        return getattr(self, name)(features, mask)

    def get_image_embeddings(self, batched_input: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(preprocess_image(batched_input, self.img_size))

    def _run_decoder(self, idx, image_embeddings, sparse, dense, multimask_output=True):
        return self.mask_decoders[idx](image_embeddings, self.prompt_encoder.get_dense_pe(),
                                       sparse, dense, multimask_output)

    def unprompted_decoders(self, image_embeddings, multimask_output=True, indices=None):
        """Every (or ``indices``) decoder without prompts, the prompt
        encoder's outputs detached as in a prompted pass → per-decoder lists
        ``(logits, iou, features)``."""
        sparse, dense = (t.detach() for t in self.prompt_encoder())
        indices = range(self.num_decoders) if indices is None else indices
        outs = [self._run_decoder(i, image_embeddings, sparse, dense, multimask_output)
                for i in indices]
        return [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs]

    @torch.no_grad()
    def raw_decoder_softmaxes(self, image_embeddings, multimask_output=True, unprompted=None):
        """Detached softmaxes of every decoder's unprompted logits, stacked
        ``(n, B, H, W, C)``: the ingredients of the per-``prompt_idx``
        pseudo-label ensembles. ``unprompted`` reuses logits already computed
        on the same embeddings."""
        logits = (unprompted if unprompted is not None
                  else self.unprompted_decoders(image_embeddings, multimask_output)[0])
        return torch.stack([lrl.detach().to(torch.float32).softmax(-1) for lrl in logits])

    def forward(self, batched_input, multimask_output=True, image_size=None, prompt_idx: int = -1,
                prompt_mode=None, image_embeddings=None, train: bool = False, prompts=None,
                generator=None, unprompted=None):
        return self.forward_train(batched_input, multimask_output, image_size, prompt_idx,
                                  prompt_mode, image_embeddings, train=train, prompts=prompts,
                                  generator=generator, unprompted=unprompted)

    def forward_train(self, batched_input, multimask_output, image_size, prompt_idx: int = -1,
                      prompt_mode=None, image_embeddings=None, train: bool = False, prompts=None,
                      generator=None, unprompted=None):
        """``prompt_idx < 0``: every decoder unprompted (prompt encoder not
        detached). ``prompt_idx = p``: the other decoders run unprompted, and
        decoder ``p`` runs twice, on the center/fit and the random/loose
        prompts, in one 2B batch. The prompts are ``prompts`` (the 5-tuple of
        :func:`prompt_generate_random_fast`), or generated here from the other
        decoders' softmax ensemble with ``generator``.

        ``unprompted`` (the output of :meth:`unprompted_decoders` on the
        same embeddings) is reused in place of running the other decoders
        again: eager PyTorch has no common-subexpression elimination, and the
        trainer's three prompted passes share that stack. Masks at
        ``image_size`` are computed only when not training (the training
        losses read the low-res logits).
        """
        if image_embeddings is None:
            image_embeddings = self.get_image_embeddings(batched_input)
        prompt = None
        if prompt_idx >= 0 and prompt_mode is not None:
            modes = list(prompt_mode) if isinstance(prompt_mode, (list, tuple)) else [prompt_mode]
            prompt = modes[prompt_idx % len(modes)]

        if self.dropout_rate > 0 and train:
            keep = torch.rand(image_embeddings.shape[:1] + (1, 1) + image_embeddings.shape[-1:],
                              generator=generator, device=image_embeddings.device)
            keep = (keep < 1.0 - self.dropout_rate).to(image_embeddings.dtype)
            dropout_embeddings = image_embeddings * keep / (1.0 - self.dropout_rate)
        else:
            dropout_embeddings = image_embeddings

        n = self.num_decoders
        low_res_logits, iou_predictions, dense_features = [None] * n, [None] * n, [None] * n
        low_res_logits_r, iou_predictions_r, dense_features_r = [None] * n, [None] * n, [None] * n
        indices = [i for i in range(n) if i != prompt_idx]
        if prompt_idx >= 0:
            if unprompted is None:
                unprompted = self.unprompted_decoders(dropout_embeddings, multimask_output)
            for i in indices:
                low_res_logits[i], iou_predictions[i], dense_features[i] = (
                    unprompted[0][i], unprompted[1][i], unprompted[2][i])
        else:
            sparse, dense = self.prompt_encoder()
            for i in indices:
                low_res_logits[i], iou_predictions[i], dense_features[i] = self._run_decoder(
                    i, dropout_embeddings, sparse, dense, multimask_output)

        if 0 <= prompt_idx < n:
            if prompts is None:
                if self.dropout_rate > 0 and train:
                    raw = self.unprompted_decoders(image_embeddings, multimask_output, indices)[0]
                else:
                    raw = [low_res_logits[i] for i in indices]
                assemble = sum(r.detach().to(torch.float32).softmax(-1) for r in raw) / (n - 1)
                prompts = prompt_generate_random_fast(
                    assemble, image_size, (self.embedding_size * 4,) * 2,
                    self.num_points_prompt, self.bbox_change_rate, generator=generator)
            sparse_p, sparse_r, dense_p = self._get_prompt_embeddings(*prompts, prompt)
            bsz = sparse_p.shape[0]
            emb2 = torch.cat([dropout_embeddings, dropout_embeddings], 0)
            lrl2, iou2, feats2 = self._run_decoder(
                prompt_idx, emb2, torch.cat([sparse_p, sparse_r], 0),
                torch.cat([dense_p, dense_p], 0), multimask_output)
            low_res_logits[prompt_idx], low_res_logits_r[prompt_idx] = lrl2[:bsz], lrl2[bsz:]
            iou_predictions[prompt_idx], iou_predictions_r[prompt_idx] = iou2[:bsz], iou2[bsz:]
            dense_features[prompt_idx], dense_features_r[prompt_idx] = feats2[:bsz], feats2[bsz:]

        masks = [None] * n
        if not train:
            masks = [postprocess_masks(lrl, self.img_size, (image_size, image_size),
                                       (image_size, image_size)) if lrl is not None else None
                     for lrl in low_res_logits]
        return {
            "masks": masks,
            "iou_predictions": iou_predictions,
            "low_res_logits": low_res_logits,
            "low_res_logits_r": low_res_logits_r,
            "dense_features": dense_features,
            "dense_features_r": dense_features_r,
        }

    def _get_prompt_embeddings(self, points, points_random, fit_boxes, loose_boxes, mask_prompt,
                               prompt):
        """Prompt-mode dispatch → ``(sparse, sparse_random, dense)``."""
        pe = self.prompt_encoder
        if prompt == "point":
            sparse, dense = pe(points=points)
            sparse_r, _ = pe(points=points_random)
        elif prompt == "box":
            sparse, dense = pe(boxes=fit_boxes)
            sparse_r, _ = pe(boxes=loose_boxes)
        elif prompt == "mask":
            sparse, dense = pe(masks=mask_prompt)
            sparse_r = sparse
        elif prompt == "point-box":
            sparse, dense = pe(points=points, boxes=fit_boxes)
            sparse_r, _ = pe(points=points_random, boxes=loose_boxes)
        elif prompt == "point-mask":
            sparse, dense = pe(points=points, masks=mask_prompt)
            sparse_r, _ = pe(points=points_random)
        elif prompt == "box-mask":
            sparse, dense = pe(boxes=fit_boxes, masks=mask_prompt)
            sparse_r, _ = pe(boxes=loose_boxes)
        elif prompt == "all":
            sparse, dense = pe(points=points, boxes=fit_boxes, masks=mask_prompt)
            sparse_r, _ = pe(points=points_random, boxes=loose_boxes, masks=mask_prompt)
        else:
            sparse, dense = pe()
            sparse_r = sparse
        return sparse, sparse_r, dense

    def forward_test(self, image, multimask_output=True, points=None, boxes=None, masks=None):
        """Decoder 0 with the given prompts (the intended semantics of the
        reference's broken ``forward_test``); thresholded masks."""
        image_embeddings = self.get_image_embeddings(image)
        sparse, dense = self.prompt_encoder(points=points, boxes=boxes, masks=masks)
        low_res_masks, iou_predictions, _ = self._run_decoder(0, image_embeddings, sparse, dense,
                                                              multimask_output)
        h, w = image.shape[1], image.shape[2]
        out_masks = postprocess_masks(low_res_masks, self.img_size, (h, w), (h, w))
        return {"masks": out_masks > self.mask_threshold, "iou_predictions": iou_predictions,
                "low_res_logits": low_res_masks}
