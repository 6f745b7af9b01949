"""Byzantine-robust training on one card (``repro.train``'s port)."""
from .step import TrainSetup, make_train_step

__all__ = ["TrainSetup", "make_train_step"]
