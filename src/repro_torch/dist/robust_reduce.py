"""Robust aggregation of stacked symmetric matrices (the port of
``repro.dist.robust_reduce.aggregate_symmetric_stacked``)."""
from __future__ import annotations

from typing import Union

import torch

from ..core.estimator import Estimator

__all__ = ["aggregate_symmetric_stacked"]


def aggregate_symmetric_stacked(mats, est: Union[str, Estimator] = "vrmom"):
    """Robustly aggregate a stack of symmetric matrices ``[.., W, p, p]``
    over its worker axis W (leading axes are replications).

    Used by the inference layer for the per-machine Hessian and
    gradient-second-moment stacks. Only the ``p(p+1)/2`` upper-triangle
    coordinates are aggregated, as one ``[W, R·p(p+1)/2]`` stack through
    the Estimator, and the aggregated triangle is mirrored back, so the
    output is *exactly* symmetric (which downstream solves deserve).
    """
    est = Estimator.coerce(est).require_stackable(
        "symmetric-stack aggregation (dist.robust_reduce)")
    if mats.ndim < 3 or mats.shape[-1] != mats.shape[-2]:
        raise ValueError(f"expected [.., W, p, p] symmetric stack, got "
                         f"{tuple(mats.shape)}")
    p = mats.shape[-1]
    iu = torch.triu_indices(p, p, device=mats.device)
    tri = mats[..., iu[0], iu[1]].float()          # [.., W, p(p+1)/2]
    agg = est.apply(tri, axis=tri.ndim - 2)        # [.., p(p+1)/2]
    out = torch.zeros(agg.shape[:-1] + (p, p), dtype=torch.float32,
                      device=mats.device)
    out[..., iu[0], iu[1]] = agg
    out = out + torch.triu(out, 1).transpose(-1, -2)
    return out.to(mats.dtype)
