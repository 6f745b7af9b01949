"""whisper-medium [audio]: enc-dec, conv frontend stubbed
[arXiv:2212.04356]."""
from .base import ArchConfig, EncoderConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, rope=False, tie_embeddings=True,
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
    source="arXiv:2212.04356",
)
