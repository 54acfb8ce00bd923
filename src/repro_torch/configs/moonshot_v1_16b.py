"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf]: 64e top-6 MoE.

48L, d_model=2048, 16H (kv=16, MHA), d_ff=1408 per expert, vocab=163840.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, head_dim=128, n_experts=64, top_k=6,
    notes="fine-grained 64e top-6; full attention (skip long_500k)",
)

SMOKE = ArchConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab=512,
    head_dim=16, n_experts=8, top_k=2,
)
