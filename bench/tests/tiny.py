"""Helpers of the benchmark's own tests: the port on the import path, and a tiny copy of the benchmark."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SRC = ROOT / "src"
sys.path[:0] = [str(ROOT), str(SRC)]

# tiny sizes that keep every cell's shapes and calls: the pool, the tile grid, the test sets
TINY = {"n_train": 512, "n_test": 256, "tile_size": 64}
TINY_MIX = {"warm_uncertainty": {"trace_requests": 4}, "train": {"steps": 3}, "cold": {"trace_requests": 3}}

DRIVER = """
import json, sys, time
T = time.perf_counter()
sys.path[:0] = [{root!r}, {src!r}]
from bench import harness
{patch}
spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
result = harness.run_cell(spec, {cell!r}, {seed}, {seconds}, {trace}, "cpu", T)
print(json.dumps(result))
"""


def make_tiny_copy(dst: Path) -> Path:
    """A copy of the benchmark under ``dst`` at tiny sizes: each config and mix file rewritten in place."""
    shutil.copytree(BENCH, dst / "bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for f in (dst / "bench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update({k: v for k, v in TINY.items() if k in cfg})
        f.write_text(json.dumps(cfg))
    for name, over in TINY_MIX.items():
        f = dst / "bench" / "traffic" / f"{name}.json"
        f.write_text(json.dumps({**json.loads(f.read_text()), **over}))
    return dst


def run_tiny(root: Path, cell: str, seconds: float = 0.5, trace: bool = False, seed: int = 2**31 + 12345,
             patch: str = "") -> dict:
    """Run ``cell`` of the copy at ``root`` on the CPU in a fresh process; returns its last line and stderr."""
    code = DRIVER.format(root=str(root), src=str(SRC), patch=patch, cell=cell, seed=seed, seconds=seconds, trace=trace)
    env = {**os.environ, "PYTHONPATH": ""}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {"line": json.loads(proc.stdout.strip().splitlines()[-1]), "stderr": proc.stderr}
