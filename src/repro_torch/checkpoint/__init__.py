"""Checkpoints in ``repro``'s format: one ``.npz`` payload and a JSON
manifest (``repro.checkpoint``'s port).

``save(path, tree)`` writes every leaf of a dict tree of tensors (params,
optimizer state) into ``arrays.npz`` as ``a0 … aN`` in JAX's flatten
order (dict keys sorted, recursively) and ``tree.json`` with ``n`` and
the leaves' ``dtypes``. npz has no bf16, so a bf16 leaf is stored as its
``uint16`` bit pattern, as ``repro`` stores it. A checkpoint of the
port's params and optimizer state therefore restores in ``repro`` into
the same tree, and the reverse, bit for bit.

``restore(path, like)`` loads the leaves into the structure of ``like``
(a template tree of the same shape), each cast to the template leaf's
dtype and placed on its device. As in ``repro``, the template's structure
is trusted and the manifest is for tooling.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..tree import leaves, unflatten

__all__ = ["save", "restore"]

_META = "tree.json"
_DATA = "arrays.npz"


def save(path: str, tree) -> None:
    os.makedirs(path, exist_ok=True)
    arrays, dtypes = {}, []
    for i, x in enumerate(leaves(tree)):
        x = x.detach().cpu()
        dtypes.append(str(x.dtype).removeprefix("torch."))
        if x.dtype == torch.bfloat16:  # npz has no bf16: store raw bits
            arrays[f"a{i}"] = x.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[f"a{i}"] = x.numpy()
    np.savez(os.path.join(path, _DATA), **arrays)
    with open(os.path.join(path, _META), "w") as f:
        json.dump({"n": len(dtypes), "dtypes": dtypes}, f)


def restore(path: str, like):
    """Restore into the structure, dtypes and devices of ``like``."""
    flat_like = list(leaves(like))
    with np.load(os.path.join(path, _DATA)) as z:
        flat = [z[f"a{i}"] for i in range(len(flat_like))]
    out = []
    for a, ref in zip(flat, flat_like):
        if a.dtype == np.uint16 and ref.dtype == torch.bfloat16:
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a).copy())
        out.append(t.to(device=ref.device, dtype=ref.dtype))
    return unflatten(like, out)
