"""Cells of the benchmark cut to a few thousand parameters, for tests on the CPU."""

from __future__ import annotations

import copy

from portbench import harness


def tiny(name: str, traced: bool = False, **mix) -> harness.Cell:
    """The cell ``name`` at tiny widths and lengths: its files, its limits, its code."""
    cell = harness.load_cell(name, traced)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                       intermediate_size=96, vocab_size=512, num_hidden_layers=2, head_dim=16)
    if "num_local_experts" in cell.config:
        cell.config["num_local_experts"] = 4
    if "rope_scaling" in cell.config:
        cell.config["rope_scaling"] = {"type": "mrope", "mrope_section": [2, 3, 3]}
    cell.mix = copy.deepcopy(cell.mix)
    cell.mix.update(batch=2, seq=64)
    if cell.mix["segments"]:
        cell.mix["segments"] = [{"text": 4}, {"image": [1, 4, 6]}]
    cell.mix.update(mix)
    return cell
