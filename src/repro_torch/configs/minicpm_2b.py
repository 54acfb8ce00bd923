"""minicpm-2b [arXiv:2404.06395; hf]: llama-like dense with WSD schedule.

40L, d_model=2304, 36H (kv=36, MHA), d_ff=5760, vocab=122753.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753, head_dim=64, schedule="wsd",
    notes="WSD schedule (train/optimizer.py); full attention (skip long_500k)",
)

SMOKE = ArchConfig(
    name="minicpm-2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    head_dim=16, schedule="wsd",
)
