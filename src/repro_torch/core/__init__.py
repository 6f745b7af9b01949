"""The estimator core: VRMOM (estimator and theory), coordinate-wise
aggregators, the backend-dispatched ``Estimator``, the attack zoo and RCSL
(Algorithm 1)."""
from . import aggregators, attacks, estimator, rcsl, vrmom
from .estimator import Estimator

__all__ = ["aggregators", "attacks", "estimator", "rcsl", "vrmom",
           "Estimator"]
