"""minitron-4b [dense]: pruned nemotron, 256k vocab [arXiv:2407.14679]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=9216, vocab=256000, tie_embeddings=False,
    source="arXiv:2407.14679",
)
