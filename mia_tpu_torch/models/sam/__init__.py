"""SAM in the port: ViT encoder (K2, K3, K4; LoRA), prompt encoders,
two-way transformer, mask decoders, ``Sam`` and ``SamPredictor`` (serving),
CPC-SAM's ``SamDualmask`` with its prompt generation (K5) and volume
validation."""

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
    "MaskDecoder",
    "MaskDecoderPromptLarge",
    "PositionEmbeddingRandom",
    "PromptEncoder",
    "PromptEncoderPromptClass",
    "ResizeLongestSide",
    "Sam",
    "SamDualmask",
    "SamPredictor",
    "TwoWayTransformer",
    "freeze_wrt_mask",
    "import_torch_sam_encoder",
    "load_lora_state_dict",
    "lora_state_dict",
    "lora_trainable_mask",
    "postprocess_masks",
    "preprocess_image",
    "prompt_generate_random_fast",
    "sam_model_registry",
    "window_partition",
    "window_unpartition",
]
