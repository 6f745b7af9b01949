"""Byzantine-robust training, on one card or over the ranks of a process
group (``repro.train``'s port)."""
from .step import TrainSetup, make_serve_steps, make_train_step

__all__ = ["TrainSetup", "make_train_step", "make_serve_steps"]
