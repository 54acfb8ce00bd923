"""GPT-3 (paper's §V-B5 workload; not part of the assigned matrix).

96L, d_model=12288, 96H, d_ff=49152, vocab=50257 — used by the Fig 15 / GPT-3
communication benchmarks and available as --arch gpt3-paper.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gpt3-paper", family="dense",
    n_layers=96, d_model=12288, n_heads=96, n_kv_heads=96, d_ff=49152,
    vocab=50257, head_dim=128,
    notes="the paper's GPT-3 evaluation workload",
)

SMOKE = ArchConfig(
    name="gpt3-paper-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    head_dim=16,
)
