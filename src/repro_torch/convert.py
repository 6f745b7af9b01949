"""Parameters and optimizer state of ``repro``'s model, as numpy arrays,
into the port's.

``repro`` keeps its parameters as a pytree of JAX arrays; the caller turns
it into numpy (``jax.tree.map(np.asarray, params)``) so this module never
imports JAX. The port keeps ``repro``'s layout — ``embed`` [V, D] (tied),
``layers/*`` stacked [L, ...], ``wq``/``wk``/``wv`` [D, H, dh], ``wo``
[H, dh, D], ``q_norm``/``k_norm`` [dh], ``mlp`` ``w_gate``/``w_up`` [D, F]
and ``w_down`` [F, D] (a moe layer: ``moe`` ``router`` [D, E],
``w_gate``/``w_up`` [E, D, F], ``w_down`` [E, F, D]; an ssm layer:
``norm_ssm`` and the mamba2 block ``ssm``, whose ``A_log``, ``D`` and
``dt_bias`` are f32 in every dtype), ``norm_f`` [D], a hybrid's
``mamba_g`` / ``mamba_t`` / ``shared`` tree, and an encdec model's
``enc_layers`` / ``dec_layers`` (``self`` and ``cross`` attention) /
``norm_enc`` tree — so conversion is a checked
copy, and both sides compute the same function. Optimizer states are
dicts in ``repro``'s layout too (``optim``), so ``opt_state_from_jax``
lets a run continue from ``repro``'s state, and ``adaptive_state_from_jax``
does the same for the adaptive tier's ``AdaptiveState`` carry.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax", "opt_state_from_jax",
           "adaptive_state_from_jax", "expected_shapes"]


def _ssm_shapes(cfg, lead: tuple) -> dict:
    """A mamba2 block's leaves with the leading stack dims ``lead``."""
    s, D = cfg.ssm, cfg.d_model
    E = s.expand * D
    H, GN = E // s.head_dim, 2 * s.n_groups * s.d_state
    return {"in_proj_z": lead + (D, E), "in_proj_x": lead + (D, E),
            "in_proj_bc": lead + (D, GN), "in_proj_dt": lead + (D, H),
            "conv_x": lead + (s.d_conv, E), "conv_bc": lead + (s.d_conv, GN),
            "A_log": lead + (H,), "D": lead + (H,), "dt_bias": lead + (H,),
            "norm": lead + (E,), "out_proj": lead + (E, D)}


def _attn_shapes(cfg, lead: tuple) -> dict:
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {"wq": lead + (D, H, dh), "wk": lead + (D, Hkv, dh),
            "wv": lead + (D, Hkv, dh), "wo": lead + (H, dh, D)}
    if cfg.qk_norm:
        attn.update(q_norm=lead + (dh,), k_norm=lead + (dh,))
    return attn


def _hybrid_shapes(cfg) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    every = cfg.hybrid_attn_every
    G = cfg.n_layers // every
    tail = max(cfg.n_layers - G * every, 1)  # repro keeps one at tail 0
    return {
        "embed": (cfg.vocab, D),
        "mamba_g": {"norm": (G, every, D),
                    "ssm": _ssm_shapes(cfg, (G, every))},
        "mamba_t": {"norm": (tail, D), "ssm": _ssm_shapes(cfg, (tail,))},
        "shared": {"in_proj": (2 * D, D), "norm_attn": (D,),
                   "attn": _attn_shapes(cfg, ()), "norm_ffn": (D,),
                   "mlp": _mlp_shapes(D, F, ())},
        "norm_f": (D,),
    }


def _mlp_shapes(D: int, F: int, lead: tuple) -> dict:
    return {"w_gate": lead + (D, F), "w_up": lead + (D, F),
            "w_down": lead + (F, D)}


def _encdec_shapes(cfg) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    Le, L = (cfg.encoder.n_layers,), (cfg.n_layers,)
    return {
        "embed": (cfg.vocab, D),
        "enc_layers": {"norm_attn": Le + (D,), "attn": _attn_shapes(cfg, Le),
                       "norm_ffn": Le + (D,), "mlp": _mlp_shapes(D, F, Le)},
        "dec_layers": {"norm_self": L + (D,), "self": _attn_shapes(cfg, L),
                       "norm_cross": L + (D,), "cross": _attn_shapes(cfg, L),
                       "norm_ffn": L + (D,), "mlp": _mlp_shapes(D, F, L)},
        "norm_enc": (D,),
        "norm_f": (D,),
    }


def expected_shapes(cfg) -> dict:
    """The model's parameter shapes, keyed like the param dict."""
    if cfg.family == "hybrid":
        return _hybrid_shapes(cfg)
    if cfg.family == "encdec":
        return _encdec_shapes(cfg)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    if cfg.family == "ssm":
        layers = {"norm_ssm": (L, D), "ssm": _ssm_shapes(cfg, (L,))}
    else:
        layers = {"norm_attn": (L, D), "attn": _attn_shapes(cfg, (L,)),
                  "norm_ffn": (L, D)}
    if cfg.family == "moe":
        E = cfg.moe.n_experts
        layers["moe"] = {"router": (L, D, E), "w_gate": (L, E, D, F),
                         "w_up": (L, E, D, F), "w_down": (L, E, F, D)}
    elif cfg.family != "ssm":
        layers["mlp"] = _mlp_shapes(D, F, (L,))
    shapes = {"embed": (cfg.vocab, D), "layers": layers, "norm_f": (D,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, cfg.vocab)
    return shapes


def _leaf(a, want, name: str, device):
    a = np.asarray(a)
    if tuple(a.shape) != tuple(want):
        raise ValueError(f"param {name}: shape {a.shape}, expected {want}")
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: reinterpret bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    elif a.dtype in (np.float32, np.int32):
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    else:
        raise TypeError(f"param {name}: dtype {a.dtype} not supported "
                        f"(float32, bfloat16, int32)")
    return t.to(device)


def _convert(tree, shapes, prefix, device):
    extra = set(tree) - set(shapes)
    missing = set(shapes) - set(tree)
    if extra or missing:
        raise ValueError(f"param tree at {prefix or '<root>'}: unexpected "
                         f"{sorted(extra)}, missing {sorted(missing)}")
    out = {}
    for key, want in shapes.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(want, dict):
            out[key] = _convert(tree[key], want, name, device)
        else:
            out[key] = _leaf(tree[key], want, name, device)
    return out


def params_from_jax(np_tree, cfg, device=None):
    """``repro``'s param pytree (numpy leaves, f32 or
    ``ml_dtypes.bfloat16``) -> the port's param dict on ``device`` (the card
    unless the caller names another)."""
    return _convert(np_tree, expected_shapes(cfg), "", resolve_device(device))


def _any_tree(tree, name: str, device):
    if isinstance(tree, dict):
        return {k: _any_tree(v, f"{name}/{k}", device)
                for k, v in tree.items()}
    return _leaf(tree, np.shape(tree), name, device)


def opt_state_from_jax(np_state, cfg, device=None):
    """``repro``'s optimizer state (``repro.optim``; numpy leaves, f32,
    bf16 or int32) -> the port's, on ``device`` (the card unless named).
    Moments that mirror the params (``m``; adamw's ``v``) are checked
    against the model's shapes; adafactor's factored ``v`` and the
    ``step`` counter are copied as they are."""
    device = resolve_device(device)
    shapes = expected_shapes(cfg)
    out = {}
    for key, sub in np_state.items():
        # adafactor's v holds a dict of vr/vc (or v) in each param's place
        factored = key == "v" and isinstance(sub.get("embed"), dict)
        if key in ("m", "v") and not factored:
            out[key] = _convert(sub, shapes, key, device)
        else:
            out[key] = _any_tree(sub, key, device)
    return out


def adaptive_state_from_jax(np_state, device=None):
    """``repro``'s ``core.adaptive.AdaptiveState`` (its fields as numpy:
    ``weights`` [W] f32, ``momentum`` [C] f32 in ``repro``'s ravel order,
    ``step`` int32, ``alpha_hat`` f32) -> the port's, on ``device`` (the
    card unless named)."""
    from .core.adaptive import AdaptiveState

    device = resolve_device(device)
    want = {"weights": np.float32, "momentum": np.float32, "step": np.int32,
            "alpha_hat": np.float32}
    out = {}
    for name, dtype in want.items():
        a = np.asarray(getattr(np_state, name))
        if a.dtype != dtype:
            raise TypeError(f"adaptive state {name}: dtype {a.dtype}, "
                            f"expected {np.dtype(dtype).name}")
        if a.ndim != (1 if name in ("weights", "momentum") else 0):
            raise ValueError(f"adaptive state {name}: shape {a.shape}")
        out[name] = _leaf(a, a.shape, name, device)
    return AdaptiveState(**out)
