"""Unified robust-aggregation layer: one backend-dispatched Estimator.

The port's counterpart of ``repro.core.estimator``: a hashable spec

    Estimator(method, K=10, beta=0.1, backend="auto", n_byzantine=0)

with ``apply(x, axis=0)`` mapping ``[m, ...] -> [...]`` and
``apply_sample`` for the serving tail. Backends:

* ``"torch"`` — the plain :mod:`core.aggregators` and
  :mod:`core.adaptive` functions (``repro``'s ``"jnp"``), the reference
  semantics; the only backend of the whole-vector methods
  (geometric_median, krum).
* ``"ref"``   — the fused single-reshape oracles in :mod:`kernels.ref`
  (coordinate-wise methods only).
* ``"cuda"``  — the CUDA kernels in :mod:`kernels.vrmom` (``repro``'s
  ``"pallas"``): B1 for ``apply``, B4 for ``apply_sample``. For a tensor
  on the CPU the kernel wrapper runs its plain version.
* ``"auto"``  — ``"cuda"`` for the methods with a fused kernel (median,
  mom, trimmed_mean, vrmom), ``"ref"`` for the mean, ``"torch"`` for the
  whole-vector and adaptive methods.

The adaptive methods (auto_gm, vrmom_adaptive; :mod:`core.adaptive`) run
their plain code on every backend but take B1 for the census centre and
the VRMOM rungs on ``"auto"`` and ``"cuda"``. For them and the
whole-vector methods, ``apply(x, axis)`` treats the dims before ``axis``
as independent batches (one census, one Weiszfeld or Krum each) and the
dims after it as a row's coordinates: ``repro`` maps them over its
replications.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lint.hashguard import check_hashable_fields
from . import aggregators as _A

__all__ = ["Estimator", "COORDINATEWISE_METHODS", "WHOLE_VECTOR_METHODS",
           "ADAPTIVE_METHODS", "METHODS", "BACKENDS"]

COORDINATEWISE_METHODS = ("mean", "median", "mom", "trimmed_mean", "vrmom")
WHOLE_VECTOR_METHODS = ("geometric_median", "krum")
ADAPTIVE_METHODS = ("auto_gm", "vrmom_adaptive")
METHODS = COORDINATEWISE_METHODS + WHOLE_VECTOR_METHODS + ADAPTIVE_METHODS
BACKENDS = ("auto", "torch", "ref", "cuda")

# Methods "auto" sends to the fused kernel: the ones whose order statistics
# need the sort. The mean gains nothing from it and goes to "ref".
_FUSED_METHODS = frozenset(("median", "mom", "trimmed_mean", "vrmom"))


class Estimator(NamedTuple):
    """Robust-aggregation spec: method + knobs + execution backend.

    method:      one of ``METHODS`` ("mom" is an alias of "median").
    K:           VRMOM quantile levels (vrmom, and vrmom_adaptive's
                 honest rung; ignored by other methods).
    beta:        trimmed-mean trim fraction per end (ignored otherwise).
    backend:     one of ``BACKENDS``; see the module docstring.
    n_byzantine: Krum's assumed corrupted-row count (ignored otherwise).
    """

    method: str = "vrmom"
    K: int = 10
    beta: float = 0.1
    backend: str = "auto"
    n_byzantine: int = 0

    @classmethod
    def coerce(cls, spec, **defaults) -> "Estimator":
        """Normalize a method name or an Estimator into an Estimator.

        ``defaults`` are constructor overrides applied only when coercing
        from a string — an explicit Estimator is taken verbatim.
        """
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls(method=spec, **defaults)
        raise TypeError(
            f"expected a method name or an Estimator, got {type(spec)!r}")

    @property
    def coordinatewise(self) -> bool:
        return self.method in COORDINATEWISE_METHODS

    @property
    def adaptive(self) -> bool:
        return self.method in ADAPTIVE_METHODS

    def require_coordinatewise(self, where: str = "chunked aggregation"):
        """Whole-vector estimators cannot aggregate coordinate shards."""
        if not self.coordinatewise:
            raise ValueError(
                f"estimator {self.method!r} is a whole-vector estimator "
                f"(selects/scores entire worker rows) and cannot be used "
                f"for {where}: the coordinate-wise wire format would hand "
                f"it shards of coordinates and produce wrong shards. Use "
                f"one of {COORDINATEWISE_METHODS} instead.")
        return self

    def require_stackable(self, where: str = "full-stack aggregation"):
        """Gate for wires that hold complete worker rows (serve replica
        logits): coordinate-wise and adaptive estimators qualify,
        whole-vector selectors do not."""
        if not (self.coordinatewise or self.adaptive):
            raise ValueError(
                f"estimator {self.method!r} cannot be used for {where}: "
                f"only coordinate-wise ({COORDINATEWISE_METHODS}) and "
                f"adaptive ({ADAPTIVE_METHODS}) estimators aggregate a "
                f"full row stack into a per-coordinate result; "
                f"{self.method!r} is a whole-vector selector.")
        return self

    def validate(self, m: int) -> "Estimator":
        """Validate the spec against a worker count (before any compute)."""
        if self.method not in METHODS:
            raise ValueError(
                f"unknown estimator method {self.method!r}; "
                f"known: {METHODS}")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; known: {BACKENDS}")
        if self.backend == "ref" or (self.backend == "cuda"
                                     and not self.adaptive):
            self.require_coordinatewise(f"backend={self.backend!r}")
        if m < 1:
            raise ValueError(f"worker axis must be non-empty, got m={m}")
        if self.method == "trimmed_mean":
            k = int(self.beta * m)
            if k == 0:
                raise ValueError(
                    f"trimmed_mean with beta={self.beta} trims "
                    f"int({self.beta}*{m}) = 0 rows per end and silently "
                    f"degrades to the mean (no robustness). Raise beta to "
                    f"at least {1.0 / m:.4g} or use another method.")
            if m - 2 * k < 1:
                raise ValueError(
                    f"trimmed_mean with beta={self.beta} trims "
                    f"2*{k} >= m={m} rows: nothing left to average")
        if self.method in ("vrmom", "vrmom_adaptive") and self.K < 1:
            raise ValueError(f"{self.method} needs K >= 1, got K={self.K}")
        return self

    def resolve_backend(self) -> str:
        """The concrete backend ``apply`` will run ("auto" resolved): the
        whole-vector and adaptive methods run the plain functions, which
        take B1 inside on ``"auto"``/``"cuda"``."""
        if not self.coordinatewise:
            return "torch"
        if self.backend != "auto":
            return self.backend
        return "cuda" if self.method in _FUSED_METHODS else "ref"

    def apply(self, x, axis: int = 0):
        """Aggregate ``x`` over ``axis``: ``[.., m, ..] -> [..]``; f32 math on
        the fused backends, the input dtype out."""
        m = x.shape[axis]
        self.validate(m)
        backend = self.resolve_backend()
        if backend == "torch":
            return self._apply_torch(x, axis)
        x = torch.movedim(x, axis, 0)
        shape = x.shape[1:]
        flat = x.reshape(m, -1).contiguous()
        if backend == "ref":
            out = self._apply_ref(flat)
        else:
            from ..kernels.vrmom import aggregate

            out = aggregate(flat, method=self.method, K=self.K,
                            beta=self.beta)
        return out.reshape(shape)

    def apply_sample(self, x, top_k: int = 0, with_agg: bool = True):
        """Aggregation + sampling tail over an ``[m, B, V]`` stack.

        On the ``"cuda"`` backend this is ONE fused kernel (B4); every
        other backend, and every adaptive method, computes the aggregate
        with ``apply`` (an adaptive method: one census over the
        ``[m, B·V]`` rows) and runs the same selection in PyTorch, so
        tokens agree across backends (bit-identical for greedy). Returns ``(agg, tok [B] int32)`` for
        greedy or ``(agg, topv [B, k], topi [B, k])`` for top-k, in
        (value descending, index ascending) order; ``agg`` is None when
        ``with_agg=False`` on the fused path.
        """
        if x.ndim != 3:
            raise ValueError(
                f"apply_sample wants [m, B, V] logit stacks, got "
                f"{tuple(x.shape)}")
        self.validate(x.shape[0])
        if self.resolve_backend() == "cuda":
            from ..kernels.vrmom import aggregate_sample

            return aggregate_sample(x.contiguous(), method=self.method,
                                    K=self.K, beta=self.beta, top_k=top_k,
                                    with_agg=with_agg)
        agg = self.apply(x, axis=0)
        if top_k == 0:
            return agg, torch.argmax(agg, dim=-1).to(torch.int32)
        vals, idx = torch.sort(agg, dim=-1, descending=True, stable=True)
        return agg, vals[:, :top_k], idx[:, :top_k].to(torch.int32)

    def init_adaptive_state(self, n_workers: int, dim: int, device=None):
        """A fresh honest-prior :class:`core.adaptive.AdaptiveState` for
        ``apply_adaptive`` (adaptive methods only), on ``device`` (the card
        unless named)."""
        from . import adaptive as _AD

        self._require_adaptive()
        return _AD.init_state(n_workers, dim, device=device)

    def apply_adaptive(self, x, state, axis: int = 0, *,
                       weights_beta: float = 0.5, momentum: float = 0.0):
        """Stateful adaptive aggregate: ``(aggregate, new_state)``; thread
        the returned state into the next call. On an honest stack the
        stateless ``apply`` and ``apply_adaptive`` from a fresh state agree
        bit for bit (unit weights are an EMA fixed point and
        ``momentum=0.0`` is exact)."""
        from . import adaptive as _AD

        self._require_adaptive()
        self.validate(x.shape[axis])
        return _AD.apply_adaptive(self.method, x, state, axis=axis, K=self.K,
                                  weights_beta=weights_beta,
                                  momentum=momentum, backend=self.backend)

    def _require_adaptive(self):
        if not self.adaptive:
            raise ValueError(
                f"estimator {self.method!r} carries no adaptive state; "
                f"adaptive methods: {ADAPTIVE_METHODS}")

    def _apply_torch(self, x, axis: int):
        if self.method == "mean":
            return _A.mean(x, axis=axis)
        if self.method in ("median", "mom"):
            return _A.median(x, axis=axis)
        if self.method == "trimmed_mean":
            return _A.trimmed_mean(x, beta=self.beta, axis=axis)
        if self.method == "vrmom":
            return _A.vrmom(x, K=self.K, axis=axis)
        if self.method == "geometric_median":
            return _A.geometric_median(x, axis=axis)
        if self.method == "krum":
            return _A.krum(x, n_byzantine=self.n_byzantine, axis=axis)
        from . import adaptive as _AD

        if self.method == "auto_gm":
            return _AD.auto_gm(x, axis=axis, backend=self.backend)
        return _AD.vrmom_adaptive(x, K=self.K, axis=axis,
                                  backend=self.backend)

    def _apply_ref(self, flat):
        from ..kernels import ref as _R

        if self.method == "mean":
            return _R.ref_mean(flat)
        if self.method in ("median", "mom"):
            return _R.ref_mom(flat)
        if self.method == "trimmed_mean":
            return _R.ref_trimmed_mean(flat, beta=self.beta)
        return _R.ref_vrmom(flat, K=self.K)


# Construction-time hashability backstop (reprolint RL004): an Estimator
# carrying an unhashable field (a list of betas, a tensor-valued K) would
# fail where it keys a cache, far from its cause. typing.NamedTuple
# forbids overriding __new__ in the class body, so the guard wraps it
# after the definition. ``_replace`` builds through the raw tuple
# constructor and skips it, as in repro.
_orig_new = Estimator.__new__


def _checked_new(cls, *args, **kwargs):
    self = _orig_new(cls, *args, **kwargs)
    check_hashable_fields(self)
    return self


Estimator.__new__ = _checked_new
