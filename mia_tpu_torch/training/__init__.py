from .al_config import ALConfig
from .al_trainer import ALTrainer
from .base_trainer import BaseTrainer
from .cpcsam_trainer import CPCSAMConfig, CPCSAMTrainer, patients_to_slices
from .state import ClippedAdam, ClippedSGD, TrainState, make_optimizer
from .steps import eval_step, make_train_step, predict
from .unet_trainer import SemiTrainer, UNetTrainer

__all__ = [
    "ALConfig",
    "ALTrainer",
    "BaseTrainer",
    "CPCSAMConfig",
    "CPCSAMTrainer",
    "ClippedAdam",
    "ClippedSGD",
    "SemiTrainer",
    "TrainState",
    "UNetTrainer",
    "eval_step",
    "make_optimizer",
    "make_train_step",
    "patients_to_slices",
    "predict",
]
