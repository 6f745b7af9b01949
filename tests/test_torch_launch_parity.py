"""The port's FLOP count (``launch.op_cost.counting("cpu")``, the plain
versions on meta tensors) against ``repro.launch.hlo_cost.analyze`` of the
compiled reference, for one reduced config of each family: the prefill,
the loss and its gradients, at B 2 x S 128.

Equal, but for three differences, each pinned exactly by the products
that make it:

* moe: ``repro`` dispatches and combines by one-hot einsums (``tec,td->
  ecd`` and ``tec,ecd->td``, 2 * T * E * C * D each a group and layer,
  ``src/repro/models/moe.py:79,94``); the port's ``index_select`` and
  ``index_add`` make no product. Their backward adds 3 more of the same
  size (the tokens' and the combine weights' and experts' gradients).
* attention under autograd: ``repro``'s chunked ``mha`` checkpoints its
  chunk body (``src/repro/models/attention.py:192``) when a call has more
  than one query chunk, so its backward recomputes q.k^T, 2 * B * H * S *
  T * dh a call; the port's ``mha`` keeps its scores for the backward.
* ssm under autograd: ``repro``'s differentiated SSD holds one dot per
  ``cumsum`` over a chunk's L positions (two a layer, ``mamba2.py:89,
  129``: output [nc, B, L, H] over L, 2 * B * S * H * L each), where
  the forward has none; torch's ``cumsum`` backward is a reverse cumsum.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get as jget
from repro.launch import hlo_cost
from repro.models import model as JM
from repro_torch.configs import get as tget
from repro_torch.launch.op_cost import counting
from repro_torch.models import model as TM
from repro_torch.train.step import loss_and_grads

B, S = 2, 128
FAMILIES = {"dense": "qwen3-1.7b", "vlm": "phi-3-vision-4.2b",
            "moe": "granite-moe-3b-a800m", "ssm": "mamba2-2.7b",
            "hybrid": "zamba2-7b", "encdec": "whisper-medium"}
MOE_SEQ_CHUNK = 2048   # repro.models.moe's routing group


def _jbatch(cfg):
    f32 = jnp.float32
    b = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if cfg.family == "encdec":
        b["frames"] = jax.ShapeDtypeStruct(
            (B, cfg.encoder.n_frames, cfg.d_model), f32)
    elif cfg.family == "vlm":
        n = cfg.vision.n_patches
        b["patches"] = jax.ShapeDtypeStruct((B, n, cfg.d_model), f32)
        b["tokens"] = jax.ShapeDtypeStruct((B, S - n), jnp.int32)
    return b


def _tbatch(jb):
    return {k: torch.empty(v.shape, device="meta", dtype=(
        torch.int32 if v.dtype == jnp.int32 else torch.float32))
        for k, v in jb.items()}


@functools.lru_cache(maxsize=None)
def _repro_flops(arch, what):
    cfg = jget(arch).reduced()
    fn = {"prefill": lambda p, b: JM.prefill(p, cfg, b, cache_len=S,
                                             last_only=True),
          "loss": lambda p, b: JM.loss(p, cfg, b),
          "grad": lambda p, b: jax.value_and_grad(JM.loss)(p, cfg, b)}[what]
    hlo = jax.jit(fn).lower(JM.abstract_init(cfg), _jbatch(cfg)).compile(
        ).as_text()
    return hlo_cost.analyze(hlo)["flops"]


def _port_flops(arch, what):
    cfg = tget(arch).reduced()
    p = TM.init(cfg, torch.Generator(), device="meta")
    batch = _tbatch(_jbatch(jget(arch).reduced()))
    with counting("cpu") as oc:
        if what == "prefill":
            TM.prefill(p, cfg, batch, cache_len=S, last_only=True)
        elif what == "loss":
            TM.loss(p, cfg, batch)
        else:
            loss_and_grads(cfg, p, batch)
    return oc.cost.flops


def _moe_einsums(cfg) -> int:
    """``repro``'s dispatch and combine products of a forward."""
    m = cfg.moe
    c = min(MOE_SEQ_CHUNK, S)
    c = c if S % c == 0 else S
    C = max(int(m.capacity_factor * m.top_k * c / m.n_experts), 1)
    return cfg.n_layers * B * (S // c) * 2 * (
        2 * c * m.n_experts * C * cfg.d_model)


def _attention_recompute(cfg) -> int:
    """q.k^T again in the backward of each ``mha`` call with more than one
    query chunk: (query length, key length, calls)."""
    H, dh = cfg.n_heads, cfg.head_dim
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        F = cfg.encoder.n_frames
        calls = [(S, S, cfg.n_layers), (S, F, cfg.n_layers),
                 (F, F, cfg.encoder.n_layers)]
    elif cfg.family == "hybrid":
        calls = [(S, S, cfg.n_layers // cfg.hybrid_attn_every)]
    else:
        calls = [(S, S, cfg.n_layers)]
    return sum(n * 2 * B * H * s * t * dh for s, t, n in calls
               if -(-s // cfg.attn_chunk) > 1)


def _ssd_cumsum_dots(cfg) -> int:
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    return cfg.n_layers * 2 * (2 * B * S * H * cfg.ssm.chunk)


@pytest.mark.parametrize("what", ["prefill", "loss", "grad"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_flops_match_repro_hlo_cost(family, what):
    arch = FAMILIES[family]
    cfg = tget(arch).reduced()
    want = _repro_flops(arch, what)
    got = _port_flops(arch, what)
    diff = _moe_einsums(cfg) if cfg.moe is not None else 0
    if what == "grad":
        diff = diff * 5 // 2 + _attention_recompute(cfg) + _ssd_cumsum_dots(
            cfg)
    assert want - got == diff, (want, got)
    assert got > 0


def test_the_named_differences_at_this_size():
    """The figures the differences came to when they were found."""
    assert _moe_einsums(tget("granite-moe-3b-a800m").reduced()) == 83886080
    assert _attention_recompute(tget("qwen3-1.7b").reduced()) == 2 ** 24
    assert _attention_recompute(tget("whisper-medium").reduced()) == 18350080
    z = tget("zamba2-7b").reduced()
    assert _attention_recompute(z) + _ssd_cumsum_dots(z) == 17301504
    assert _ssd_cumsum_dots(tget("mamba2-2.7b").reduced()) == 131072
