from .loop import Trainer, TrainerConfig, TrainState, resolve_device
from .metrics import LOSSES, PREDICTION_FNS
from .optim import make_optimizer, make_scheduler

__all__ = ["Trainer", "TrainerConfig", "TrainState", "resolve_device",
           "LOSSES", "PREDICTION_FNS", "make_optimizer", "make_scheduler"]
