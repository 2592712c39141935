"""The LM train step (``repro.train``)."""
from .step import TrainConfig, make_loss_and_grads, make_train_step

__all__ = ["TrainConfig", "make_loss_and_grads", "make_train_step"]
