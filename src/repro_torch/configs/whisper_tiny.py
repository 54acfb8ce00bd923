"""whisper-tiny [arXiv:2212.04356; unverified]: enc-dec, conv frontend STUB.

4L decoder (+4L encoder), d_model=384, 6H (kv=6), d_ff=1536, vocab=51865.
The audio conv frontend is stubbed: input_specs() provides precomputed frame
embeddings (B, 1500, d_model).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    head_dim=64, enc_layers=4, enc_seq=1500,
    rope_type="learned", norm_type="layernorm", act="gelu",
    notes="enc-dec; conv frontend stub; full attention (skip long_500k)",
)

SMOKE = ArchConfig(
    name="whisper-tiny-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    head_dim=16, enc_layers=2, enc_seq=16,
    rope_type="learned", norm_type="layernorm", act="gelu",
)
