"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

A window of 4096: full-sequence attention runs the plain chunked ``mha``
(the kernels take no window) and the cache is a ring of 4096 slots. The
32 layers (~93 GB in bf16) do not fit one card; a run on one card cuts
the depth and says so."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=32000, sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2),
    source="arXiv:2401.04088",
)
