"""zamba2-7b [hybrid]: 81 Mamba2 blocks + shared attention block every 6
[arXiv:2411.15242]."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_head=112,
    d_ff=14336, vocab=32000, hybrid_attn_every=6,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64),
    source="arXiv:2411.15242",
)
