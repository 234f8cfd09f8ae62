"""A run with the timed path broken underneath comes out not correct.

Each fault of ``bench/faults.py`` is planted for one run at a tiny size on
the CPU, with the cells' own limits: a fit that returns its state
unchanged, half of the training batch left out (the posterior or the NLML
then taken over the rest), and one answer altered where it is produced.
"""

import pytest

from bench.tests.tiny import run_tiny

CASES = [
    ("gp16k.train", "unchanged"),
    ("gp16k.cold", "half_batch"),
    ("gp16k.warm", "half_batch"),
    ("gp16k.train", "half_batch"),
    ("gp16k.cold", "altered"),
    ("gp16k.warm", "altered"),
    ("gp16k.train", "altered"),
]


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_is_not_correct(tiny_root, cell, fault):
    line = run_tiny(tiny_root, cell, patch=f"from bench import faults; faults.plant({fault!r})")["line"]
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
