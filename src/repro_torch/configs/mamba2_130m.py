"""mamba2-130m [arXiv:2405.21060; unverified]: SSD (state-space duality).

24L, d_model=768, attention-free, vocab=50280, ssm_state=128.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    rope_type="none",
    notes="attention-free; constant-state decode -> runs long_500k",
)

SMOKE = ArchConfig(
    name="mamba2-130m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab=512,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    rope_type="none",
)
