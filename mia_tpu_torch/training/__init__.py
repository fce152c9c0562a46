from .al_config import ALConfig
from .al_trainer import ALTrainer
from .base_trainer import BaseTrainer
from .state import ClippedAdam, TrainState, make_optimizer
from .steps import eval_step, make_train_step, predict

__all__ = [
    "ALConfig",
    "ALTrainer",
    "BaseTrainer",
    "ClippedAdam",
    "TrainState",
    "eval_step",
    "make_optimizer",
    "make_train_step",
    "predict",
]
