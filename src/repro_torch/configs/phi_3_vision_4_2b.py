"""phi-3-vision-4.2b [vlm]: phi3-mini LM + stubbed CLIP patch embeddings
[hf:microsoft/Phi-3-vision-128k-instruct]. Head dim 96."""
from .base import ArchConfig, VisionStubConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab=32064, vision=VisionStubConfig(n_patches=256),
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
