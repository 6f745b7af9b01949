"""Byzantine attack models (Section 4 of the paper, plus extras).

An attack maps the stacked honest messages ``v`` ``[n, ...]`` to corrupted
messages, replacing the rows a boolean ``mask`` selects. Every attack has
the signature ``(generator, v, mask)``: the ``torch.Generator`` takes the
place of ``repro``'s PRNG key and is read only by the random ``gaussian``
attack (it must live on ``v``'s device).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

Attack = Callable[[Optional[torch.Generator], torch.Tensor, torch.Tensor],
                  torch.Tensor]

__all__ = ["byzantine_mask", "gaussian", "omniscient", "alie", "ipm", "mimic",
           "bitflip", "signflip", "zero", "wrong_value", "get", "attack_stack",
           "REGISTRY", "OMNISCIENT_ATTACKS", "COORDINATEWISE"]


def byzantine_mask(m_plus_1: int, alpha: float, device=None) -> torch.Tensor:
    """[m+1] bool with floor(alpha * m) Byzantine workers; row 0 (the
    trusted master) never is. The last rows are chosen (the estimators are
    permutation-invariant)."""
    n_byz = int(alpha * (m_plus_1 - 1))
    return torch.arange(m_plus_1, device=device) >= (m_plus_1 - n_byz)


def _apply(mask, honest, corrupt):
    mask = mask.to(honest.device).reshape((-1,) + (1,) * (honest.ndim - 1))
    return torch.where(mask, corrupt, honest)


def gaussian(generator, v, mask, std: float = 200.0 ** 0.5):
    """Gaussian attack: replace messages by N(0, 200*I) draws (paper 4.1)."""
    if generator is None:
        raise ValueError("the gaussian attack needs a torch.Generator")
    noise = std * torch.randn(v.shape, generator=generator, device=v.device,
                              dtype=torch.float32)
    return _apply(mask, v, noise.to(v.dtype))


def omniscient(generator, v, mask, scale: float = 1e10):
    """Omniscient attack: scaled negative of the mean over every row (paper
    4.2(b)), the mean in f32 then in v's dtype."""
    mean, _ = _honest_moments(v, torch.zeros_like(mask), with_std=False)
    return _apply(mask, v, (-scale * mean.to(v.dtype)).expand_as(v))


# coordinates of a stack made f32 at a time by the honest moments: a
# full-width gradient leaf (qwen3-1.7b's embedding, [8, 311M] bf16) would
# otherwise take several f32 copies of itself
_MOMENT_BLOCK = 1 << 24


def _rows_sum(x, keep):
    """``x`` [n, c] f32 times ``keep`` [n, 1] summed over the rows, one row
    after another: each coordinate's sum is the same bits whatever the
    stack's width or layout (a reduction kernel's order follows them), so
    an attack on a slice of the coordinates is the attack on the stack."""
    acc = x[0:1] * keep[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i:i + 1] * keep[i]
    return acc


def _honest_moments(v, mask, with_std: bool = True):
    """Per-coordinate f32 mean/std over the unmasked rows, keepdim (std
    None without ``with_std``), in blocks of ``_MOMENT_BLOCK`` coordinates
    (each coordinate's arithmetic is the same in any block, and on any
    slice of the coordinates: ``_rows_sum``)."""
    n = v.shape[0]
    flat = v.reshape(n, -1)
    keep = (~mask).to(v.device).reshape(n, 1).float()
    n_h = torch.clamp_min(torch.sum(keep, dim=0), 1.0)
    C = flat.shape[1]
    mean = torch.empty((1, C), dtype=torch.float32, device=v.device)
    std = torch.empty_like(mean) if with_std else None
    for a in range(0, C, _MOMENT_BLOCK):
        f32 = flat[:, a:a + _MOMENT_BLOCK].float()
        m = _rows_sum(f32, keep) / n_h
        mean[:, a:a + _MOMENT_BLOCK] = m
        if with_std:
            var = _rows_sum((f32 - m) ** 2, keep) / n_h
            std[:, a:a + _MOMENT_BLOCK] = torch.sqrt(torch.clamp_min(var,
                                                                     0.0))
    shape = (1,) + v.shape[1:]
    return mean.reshape(shape), None if std is None else std.reshape(shape)


@functools.lru_cache(maxsize=32)
def _alie_z(n: int, device) -> torch.Tensor:
    """[n + 1] f32: ALIE's default z for each count of corrupted rows out
    of n, the plotting-position quantile of ``repro.core.attacks.alie``
    floored at 0.2 (float64, rounded to f32 as a python-float factor of an
    f32 tensor is). Copied to the device once, so the attack reads its
    count there and a CUDA graph can capture it."""
    from scipy.special import ndtri

    zs = []
    for m in range(n + 1):
        n_h = max(n - m, 1.0)
        s = float(n // 2 + 1) - m
        q = min(max((n_h - s + 1.0) / (n_h + 1.0), 0.5), 1.0 - 1e-6)
        zs.append(max(float(ndtri(q)), 0.2))
    return torch.tensor(zs, dtype=torch.float32, device=device)


def alie(generator, v, mask, z=None):
    """ALIE (Baruch et al. 2019): Byzantine rows at honest_mean + z *
    honest_std. The default z is the plotting-position quantile of
    ``repro.core.attacks.alie``, floored at 0.2."""
    mean, std = _honest_moments(v, mask)
    if z is None:
        count = mask.to(v.device).sum().reshape(1)
        z = torch.index_select(_alie_z(v.shape[0], v.device), 0, count)
    corrupt = (mean + z * std).to(v.dtype)
    return _apply(mask, v, corrupt.expand_as(v))


def ipm(generator, v, mask, eps: float = 0.5):
    """Inner-product manipulation (Xie et al. 2020): -eps * honest mean."""
    mean, _ = _honest_moments(v, mask, with_std=False)
    return _apply(mask, v, (-eps * mean).to(v.dtype).expand_as(v))


def mimic(generator, v, mask):
    """Mimic (Karimireddy et al. 2022): every Byzantine row replays the
    honest row farthest from the honest mean."""
    mean, _ = _honest_moments(v, mask, with_std=False)
    dev = torch.sum((v.float() - mean) ** 2, dim=tuple(range(1, v.ndim)))
    dev = torch.where(mask.to(v.device), torch.full_like(dev, -float("inf")),
                      dev)
    victim = torch.argmax(dev).reshape(1)  # stays on the device
    return _apply(mask, v, torch.index_select(v, 0, victim).expand_as(v))


def bitflip(generator, v, mask, n_dims: int = 5):
    """Flip the sign of the first ``n_dims`` coordinates."""
    if v.ndim == 1:
        return _apply(mask, v, -v)
    flip = torch.where(torch.arange(v.shape[-1], device=v.device) < n_dims,
                       -1.0, 1.0).to(v.dtype)
    return _apply(mask, v, v * flip)


def signflip(generator, v, mask, scale: float = 1.0):
    """Full sign flip (classic baseline)."""
    return _apply(mask, v, -scale * v)


def zero(generator, v, mask):
    """Send zeros (drop-out / crash failure)."""
    return _apply(mask, v, torch.zeros_like(v))


def wrong_value(generator, v, mask, value: float = 100.0):
    """All Byzantine rows report the same constant."""
    return _apply(mask, v, torch.full_like(v, value))


REGISTRY = {
    "none": lambda generator, v, mask: v,
    "gaussian": gaussian,
    "omniscient": omniscient,
    "alie": alie,
    "ipm": ipm,
    "mimic": mimic,
    "bitflip": bitflip,
    "signflip": signflip,
    "zero": zero,
    "wrong_value": wrong_value,
}

OMNISCIENT_ATTACKS = ("omniscient", "alie", "ipm", "mimic")

# The attacks whose corrupted value at a coordinate depends only on the
# workers' values at that coordinate, so that on any set of columns of a
# stack they give those columns of the attacked stack: what the multi-rank
# wire needs, which attacks a rank's slice of the coordinates. ``mimic``
# picks its victim over a whole row, ``bitflip`` flips by position in the
# last dim, and ``gaussian`` draws its noise in the stack's shape, so a
# slice draws other values (tests/test_torch_rrs.py checks the split).
COORDINATEWISE = ("none", "omniscient", "alie", "ipm", "signflip", "zero",
                  "wrong_value")


def get(name: str) -> Attack:
    return REGISTRY[name]


def attack_stack(name: str, generator, v, mask, axis: int = 0):
    """Apply attack ``name`` to a stack whose worker axis is ``axis``; the
    axes before it are independent replications. Every attack but
    ``mimic`` works coordinate by coordinate, so the replications ride as
    extra coordinates of one call. ``mimic`` picks one victim row over all
    of a replication's coordinates, so it runs one replication at a
    time."""
    fn = get(name)
    if axis == 0:
        return fn(generator, v, mask)
    lead = v.shape[:axis]
    v2 = v.reshape((-1,) + v.shape[axis:])
    if name == "mimic":
        out = torch.stack([fn(generator, r, mask) for r in v2])
    else:
        out = torch.movedim(fn(generator, torch.movedim(v2, 1, 0), mask),
                            0, 1)
    return out.reshape(lead + out.shape[1:])
