from repro_torch.train.optimizer import adafactor, adamw, sgd_momentum
from repro_torch.train.trainer import TrainState, make_train_step

__all__ = ["adamw", "adafactor", "sgd_momentum", "TrainState", "make_train_step"]
