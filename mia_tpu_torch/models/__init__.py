from .flax_bridge import unet_state_dict_from_flax
from .unet import UNet, UNetConfig

__all__ = ["UNet", "UNetConfig", "unet_state_dict_from_flax"]
