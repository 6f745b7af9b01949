"""starcoder2-7b [dense]: GQA kv=4, RoPE [arXiv:2402.19173].

36 query heads over 4 kv heads: a decode group of G = 9, past the 8-head
group bound of B3's first instance."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_head=128,
    d_ff=18432, vocab=49152, tie_embeddings=False,
    source="arXiv:2402.19173",
)
