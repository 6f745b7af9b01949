"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

    B1  vrmom.aggregate                    robust aggregation over a worker axis
    B4  vrmom.aggregate_sample             aggregation + greedy / top-k tail
    B2  flash_attention.flash_attention    full-sequence attention forward
    B3  decode_attention.decode_attention  single-query attention over a cache

Execution entry points only — dispatch policy lives one layer up:
``core.estimator.Estimator`` for aggregation and ``models.attn_backend``
for attention. Sources are in ``csrc/``; ``build`` compiles and binds them.
"""
from . import ref
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .vrmom import aggregate, aggregate_sample

KERNELS = (aggregate, aggregate_sample, flash_attention, decode_attention)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


__all__ = ["ref", "aggregate", "aggregate_sample", "flash_attention",
           "decode_attention", "KERNELS", "reset_launch_counts",
           "launch_counts"]
