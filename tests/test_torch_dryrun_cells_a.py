"""``run_cell`` is ok for every smoke cell of the dense, MoE and hybrid
families, on the single-pod and the multi-pod mesh (the port's dry-run at
smoke size; the cells of the other families are in
``test_torch_dryrun_cells_b.py`` and ``_c.py``, split to keep each file
short)."""

import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs, valid_cells  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.train.steps import TrainOptions  # noqa: E402

CELLS = [(a, s, multi) for a in list_archs() if get_config(a).family in ("dense", "moe", "hybrid")
         for s in valid_cells(a) for multi in (False, True)]


@pytest.mark.parametrize("arch,shape,multi", CELLS)
def test_run_cell_is_ok(arch, shape, multi):
    rec = dryrun.run_cell(arch, shape, multi, TrainOptions(), smoke=True)
    assert rec["ok"], rec.get("traceback")
    assert rec["flops"] > 0 and rec["peak_bytes_per_rank"] >= rec["step_arg_bytes_per_rank"] > 0
    assert rec["arg_bytes_per_device"] > 0 and rec["chips"] == (512 if multi else 256)
