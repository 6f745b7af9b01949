"""The estimator core: VRMOM constants, coordinate-wise aggregators, the
backend-dispatched ``Estimator`` and the attack zoo."""
from . import aggregators, attacks, estimator, vrmom
from .estimator import Estimator

__all__ = ["aggregators", "attacks", "estimator", "vrmom", "Estimator"]
