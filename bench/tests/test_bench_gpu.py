"""On the card: each cell's control (the reference in float32 with TF32 products) fails its limits,
and the program at the cell's own size passes them.  Skips without a CUDA card."""

import importlib
import json

import pytest

from bench.tests.tiny import BENCH, ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 products exist only there")
    control = importlib.import_module("bench.control")
    from bench import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    r = control.readings(spec, cell, 2**31 + 77, 2, True, "cuda")
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert "control_crashed" in r or any(r["control"][k] > v for k, v in limits.items()), r
