"""The estimator core: VRMOM (estimator and theory), the coordinate-wise
and whole-vector aggregators, the adaptive tier, the backend-dispatched
``Estimator``, the attack zoo and RCSL (Algorithm 1)."""
from . import adaptive, aggregators, attacks, estimator, rcsl, vrmom
from .estimator import Estimator

__all__ = ["adaptive", "aggregators", "attacks", "estimator", "rcsl",
           "vrmom", "Estimator"]
