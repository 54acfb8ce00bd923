"""internlm2-20b [arXiv:2403.17297; hf]: dense GQA.

48L, d_model=6144, 48H (kv=8), d_ff=16384, vocab=92544.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92544, head_dim=128,
    notes="full attention (skip long_500k)",
)

SMOKE = ArchConfig(
    name="internlm2-20b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=8,
)
