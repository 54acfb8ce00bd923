"""qwen2-vl-7b [arXiv:2409.12191; hf]: M-RoPE, dynamic-resolution VLM.

28L, d_model=3584, 28H (kv=4), d_ff=18944, vocab=152064.  Vision tower is a
STUB: input_specs() provides token ids + 3D M-RoPE positions (t,h,w).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, head_dim=128, rope_type="mrope", mrope_sections=(16, 24, 24),
    notes="vision frontend stub; full attention (skip long_500k)",
)

SMOKE = ArchConfig(
    name="qwen2-vl-7b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    head_dim=16, rope_type="mrope", mrope_sections=(4, 2, 2),
)
