"""llama3.2-3b [hf:meta-llama/Llama-3.2-1B; unverified]: small llama3.

28L, d_model=3072, 24H (kv=8), d_ff=8192, vocab=128256.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab=128256, head_dim=128, rope_theta=500_000.0,
    notes="full attention (skip long_500k)",
)

SMOKE = ArchConfig(
    name="llama3.2-3b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, rope_theta=500_000.0,
)
