"""granite-8b [arXiv:2405.04324; hf]: llama-arch code model.

36L, d_model=4096, 32H (kv=8), d_ff=14336, vocab=49152.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=49152, head_dim=128,
    notes="full attention (skip long_500k)",
)

SMOKE = ArchConfig(
    name="granite-8b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16,
)
