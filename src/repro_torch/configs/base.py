"""Architecture configuration (dense, vlm, moe, ssm, hybrid and encdec
families).

``repro.configs.base`` imports JAX, so the port re-declares the fields of
``ArchConfig`` that the decoder and the train step read. Field names,
defaults and ``reduced()`` follow ``repro`` so a config means the same
model, and the same training set-up, on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from ..lint.hashguard import check_hashable_fields

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Top-k capacity-routed mixture of experts (``models/moe.py``)."""

    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block (``models/mamba2.py``): d_state N, expansion of
    d_model into d_inner, head dim P, B/C groups, conv width, scan chunk."""

    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder (``models/whisper.py``). The conv/mel frontend
    is a stub: inputs are precomputed frame embeddings [B, n_frames,
    d_model]."""

    n_layers: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class VisionStubConfig:
    """VLM frontend stub: precomputed patch embeddings [B, n_patches, d]."""

    n_patches: int = 256


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # "dense" | "vlm" (a dense LM behind stub patch
    # embeddings) | "moe" (the dense stack with expert FFNs) | "ssm" (a
    # stack of mamba2 blocks) | "hybrid" (mamba2 blocks and one shared
    # attention block applied every ``hybrid_attn_every`` layers) |
    # "encdec" (a whisper encoder and a decoder with cross attention)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    rope: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0  # zamba2: the shared block every k layers
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStubConfig] = None
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_chunk: int = 1024  # query-block size of the plain chunked attention
    # attention backend (models/attn_backend.py): "auto" | "torch" (the
    # plain chunked mha) | "flash" (the CUDA kernels: flash prefill and
    # grouped decode attention)
    attn_backend: str = "auto"
    # KV-cache storage dtype: None -> compute_dtype; "bfloat16" or "int8"
    # (int8 carries per-(row, position) f32 scales beside the cache)
    kv_dtype: Optional[str] = None
    loss_chunk: int = 1024  # sequence-chunked cross-entropy
    remat: bool = True  # recompute each layer in the backward
    remat_block: int = 1  # >1: two-level remat, store every Nth boundary
    optimizer: str = "adamw"  # llama3-405b overrides to adafactor
    source: str = ""  # citation

    def __post_init__(self):
        # ArchConfig keys the port's caches as repro's keys its jit
        # statics: an unhashable field fails here, naming the field
        # (reprolint RL004)
        check_hashable_fields(self)
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; known: "
                             f"{FAMILIES}")

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can run long_500k natively (without the SWA variant)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers (a hybrid 4, the shared block every
        2), d_model 128 (the ssm family 64), <= 4 heads, head dim 32, vocab
        512, f32, 4 stub patches, <= 4 experts of top_k <= 2 at the same
        capacity factor, an SSM block of d_state 16, head dim 32 and chunk
        16, an encoder of 2 layers over 12 frames, loss chunks of 32, no
        remat — the cut ``repro``'s ``reduced()`` makes."""
        n_heads = min(self.n_heads, 4)
        vision = None if self.vision is None else VisionStubConfig(
            n_patches=4)
        moe = None if self.moe is None else MoEConfig(
            n_experts=min(self.moe.n_experts, 4),
            top_k=min(self.moe.top_k, 2),
            capacity_factor=self.moe.capacity_factor)
        ssm = None if self.ssm is None else dataclasses.replace(
            self.ssm, d_state=16, head_dim=32, chunk=16)
        encoder = None if self.encoder is None else EncoderConfig(
            n_layers=2, n_frames=12)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.hybrid_attn_every else 2),
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            d_model=128 if self.family != "ssm" else 64,
            n_heads=n_heads,
            n_kv_heads=min(self.n_kv_heads, max(1, n_heads // 2)),
            d_head=32,
            d_ff=256,
            vocab=512,
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else None),
            vision=vision,
            moe=moe,
            ssm=ssm,
            encoder=encoder,
            param_dtype="float32",
            compute_dtype="float32",
            attn_chunk=16,
            loss_chunk=32,
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def input_specs(cfg: ArchConfig, shape: Union[InputShape, str],
                device="meta") -> dict:
    """Stand-ins for a step's data inputs: empty tensors on ``device`` (the
    meta device by default, which allocates nothing) with ``repro``'s
    shapes and dtypes.

    train, prefill: ``tokens`` [B, S] int32, with ``frames`` [B, n_frames,
    D] for an encdec model, or ``patches`` [B, n_patches, D] and
    ``tokens`` of ``S - n_patches`` for a vlm (the stubs in the compute
    dtype); decode: ``token`` [B] int32 (the positions are the cache's).
    """
    import torch

    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    emb = getattr(torch, cfg.compute_dtype)

    def empty(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    if shape.kind == "decode":
        return {"token": empty((B,), torch.int32)}
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    specs = {}
    if cfg.family == "encdec":
        specs["frames"] = empty((B, cfg.encoder.n_frames, cfg.d_model), emb)
    elif cfg.family == "vlm":
        n_img = cfg.vision.n_patches
        specs["patches"] = empty((B, n_img, cfg.d_model), emb)
        S -= n_img
    specs["tokens"] = empty((B, S), torch.int32)
    return specs
