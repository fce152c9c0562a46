"""SAM in the port: ViT encoder (K2, K3, K4 by default, K6-K9 by option;
LoRA), prompt encoders, two-way transformer, mask decoders, ``Sam``,
``SamPredictor`` and ``SamAutomaticMaskGenerator`` (serving), CPC-SAM's
``SamDualmask`` with its prompt generation (K5) and volume validation."""

from .amg import (
    MaskData,
    SamAutomaticMaskGenerator,
    batched_mask_to_box,
    build_point_grid,
    calculate_stability_score,
    mask_to_rle,
    rle_to_mask,
)

from .build_sam import import_torch_sam_encoder, sam_model_registry
from .common import LayerNorm, LayerNorm2d, MLPBlock
from .image_encoder import ImageEncoderViT, window_partition, window_unpartition
from .lora import freeze_wrt_mask, load_lora_state_dict, lora_state_dict, lora_trainable_mask
from .mask_decoder import MaskDecoder, MaskDecoderPromptLarge
from .predictor import SamPredictor
from .prompt_encoder import PositionEmbeddingRandom, PromptEncoder, PromptEncoderPromptClass
from .prompt_generation import prompt_generate_random_fast
from .sam import Sam, SamDualmask, postprocess_masks, preprocess_image
from .transformer import TwoWayTransformer
from .transforms import ResizeLongestSide

__all__ = [
    "ImageEncoderViT",
    "LayerNorm",
    "LayerNorm2d",
    "MLPBlock",
    "MaskData",
    "MaskDecoder",
    "MaskDecoderPromptLarge",
    "PositionEmbeddingRandom",
    "PromptEncoder",
    "PromptEncoderPromptClass",
    "ResizeLongestSide",
    "Sam",
    "SamAutomaticMaskGenerator",
    "SamDualmask",
    "SamPredictor",
    "TwoWayTransformer",
    "batched_mask_to_box",
    "build_point_grid",
    "calculate_stability_score",
    "freeze_wrt_mask",
    "import_torch_sam_encoder",
    "load_lora_state_dict",
    "lora_state_dict",
    "lora_trainable_mask",
    "mask_to_rle",
    "postprocess_masks",
    "preprocess_image",
    "prompt_generate_random_fast",
    "rle_to_mask",
    "sam_model_registry",
    "window_partition",
    "window_unpartition",
]
