"""dbrx-132b [hf:databricks/dbrx-base; unverified]: fine-grained MoE.

40L, d_model=6144, 48H (kv=8), d_ff=10752 per expert, vocab=100352,
16 experts top-4.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, head_dim=128, n_experts=16, top_k=4,
    notes="16e top-4; full attention (skip long_500k)",
)

SMOKE = ArchConfig(
    name="dbrx-132b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=512,
    head_dim=16, n_experts=4, top_k=2,
)
