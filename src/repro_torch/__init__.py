"""PyTorch/CUDA port of the JAX model stack in :mod:`repro`.

The port keeps the JAX package's module names and parameter layout, so each
module here has a counterpart there (``repro_torch.models.transformer`` ↔
``repro.models.transformer``).  It imports nothing of ``repro`` and no JAX:
where it needs code from a NumPy-only module of ``repro`` it keeps its own
copy.  Entry points run on ``cuda`` unless the caller asks for ``"cpu"``;
the CUDA kernels are built on first use (``repro_torch.kernels._build``).
"""
