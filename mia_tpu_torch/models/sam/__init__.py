"""SAM serving path of the port: ViT encoder (K2, K3, K4), prompt encoder,
two-way transformer, mask decoder, ``Sam`` and ``SamPredictor``."""

from .build_sam import sam_model_registry
from .common import LayerNorm, LayerNorm2d, MLPBlock
from .image_encoder import ImageEncoderViT, window_partition, window_unpartition
from .mask_decoder import MaskDecoder
from .predictor import SamPredictor
from .prompt_encoder import PositionEmbeddingRandom, PromptEncoder
from .sam import Sam, postprocess_masks, preprocess_image
from .transformer import TwoWayTransformer
from .transforms import ResizeLongestSide

__all__ = [
    "ImageEncoderViT",
    "LayerNorm",
    "LayerNorm2d",
    "MLPBlock",
    "MaskDecoder",
    "PositionEmbeddingRandom",
    "PromptEncoder",
    "ResizeLongestSide",
    "Sam",
    "SamPredictor",
    "TwoWayTransformer",
    "postprocess_masks",
    "preprocess_image",
    "sam_model_registry",
    "window_partition",
    "window_unpartition",
]
