"""llama3-405b [dense]: GQA kv=8, 128k vocab [arXiv:2407.21783].

128 query heads over 8 kv heads: a decode group of G = 16. The 126
layers (~810 GB in bf16) do not fit one card; a run on one card cuts the
depth and says so. Trained with adafactor (f32 Adam moments would not
fit) and two-level remat, as in ``repro``."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_head=128,
    d_ff=53248, vocab=128256, rope_theta=500_000.0, tie_embeddings=False,
    optimizer="adafactor", remat_block=7,
    source="arXiv:2407.21783",
)
