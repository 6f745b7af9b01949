"""mamba2-2.7b [ssm]: SSD, attention-free [arXiv:2405.21060]."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280, rope=False,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64),
    source="arXiv:2405.21060",
)
