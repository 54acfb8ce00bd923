"""recurrentgemma-9b [arXiv:2402.19427; unverified]: RG-LRU + local attn 1:2.

38L, d_model=4096, 16H (MQA kv=1), d_ff=12288, vocab=256000, window=2048.
Layer pattern: (recurrent, recurrent, attention) repeating.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab=256000, head_dim=256, local_window=2048, attention_period=3,
    notes="bounded-window hybrid -> runs long_500k",
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=512,
    head_dim=16, local_window=16, attention_period=3,
)
