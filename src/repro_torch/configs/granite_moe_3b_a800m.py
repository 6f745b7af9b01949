"""granite-moe-3b-a800m [moe]: 40 experts top-8, d_ff 512 an expert
[hf:ibm-granite/granite-3.0-1b-a400m-base family].

24 query heads over 8 kv heads at head dim 64: a decode group of G = 3.
The vocabulary of 49155 is not a multiple of 8. About 3.30 B parameters
(~0.88 B active a token), 6.60 GB in bf16."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
    d_ff=512, vocab=49155, moe=MoEConfig(n_experts=40, top_k=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
