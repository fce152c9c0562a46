from .flax_bridge import legacy_unet_state_dict_from_flax, unet_state_dict_from_flax
from .legacy_unet import LegacyUNet, LegacyUNetConfig
from .processor import UnetProcessor
from .torch_port import import_legacy_torch_checkpoint, import_torch_unet_checkpoint
from .unet import EinsumConvTranspose2x, UNet, UNetConfig

__all__ = [
    "EinsumConvTranspose2x",
    "LegacyUNet",
    "LegacyUNetConfig",
    "UNet",
    "UNetConfig",
    "UnetProcessor",
    "import_legacy_torch_checkpoint",
    "import_torch_unet_checkpoint",
    "legacy_unet_state_dict_from_flax",
    "unet_state_dict_from_flax",
]
