"""BENCHMARK.json against the contract's rules, and a new cell added by new files alone."""

import json
import re
import shutil

import pytest

from bench.tests.tiny import BENCH, ROOT, make_tiny_copy, run_tiny

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys_and_command():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert 1 <= len(SPEC["command"]) <= 32 and all(LINE.match(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


def test_every_name_unit_and_line():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    cells = []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert w["config"] in names
        cells.append(w["name"])
    assert len(set(cells)) == len(cells) and len(set(names)) == len(names)
    assert {(w["config"], w["traffic"]) for w in SPEC["workloads"]}.__len__() == len(cells)
    assert {w["config"] for w in SPEC["workloads"]} == set(names)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        # each cell that lists the metric reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


def test_every_cell_reports_and_is_found_by_name():
    for w in SPEC["workloads"]:
        e2e = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in SPEC["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "calls" / f"{mix['call']}.py").is_file()
        assert (BENCH / "reference" / f"{mix['call']}.py").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()


NEW_METRIC = '''"""A throwaway reader: the requests of the window."""


def read(run):
    return float(run.requests)
'''


@pytest.mark.parametrize("method", ["exact", "lowrank"])
def test_new_config_mix_metric_and_cell_by_new_files_alone(tmp_path, method):
    root = make_tiny_copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*") if p.is_file()}
    before[root / "BENCHMARK.json"] = (root / "BENCHMARK.json").read_bytes()
    bench = root / "bench"
    cfg = json.loads((bench / "configs" / "gp_16k.json").read_text())
    cfg.update(name="gp_tiny32", n_train=384, tile_size=32, n_test=128)
    if method == "lowrank":  # the Nystrom tier: the harness's low-rank route, reached by a data file alone
        cfg.update(method="lowrank", m_inducing=64, strategy="subset", jitter=1e-4)
    (bench / "configs" / "gp_tiny32.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "cold.json").read_text())
    mix.update(warmup_requests=2)
    (bench / "traffic" / "cold_twice_warm.json").write_text(json.dumps(mix))
    (bench / "metrics" / "requests_seen.py").write_text(NEW_METRIC)
    (bench / "limits" / "tiny.cold2.json").write_text(json.dumps({"mean_err": 1e-3, "mean_rms": 1e-3}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "gp_tiny32", "source": "https://arxiv.org/abs/2602.19683",
                            "file": "bench/configs/gp_tiny32.json", "reduced": [], "why": "throwaway"})
    spec["workloads"].append({"name": "tiny.cold2", "config": "gp_tiny32", "traffic": "cold_twice_warm",
                              "chips": 1, "why": "throwaway"})
    spec["end_to_end"].append({"name": "requests_seen", "unit": "requests", "better": "higher", "bound": 0.25,
                               "source": "host_clock", "workloads": ["tiny.cold2"]})
    spec["end_to_end"][1]["workloads"].append("tiny.cold2")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    # no file that was there before changed, except BENCHMARK.json's new entries
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
    line = run_tiny(root, "tiny.cold2")["line"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "cold_predict_s", "requests_seen"}
    assert line["metrics"]["requests_seen"]["value"] == line["attempted"] - mix["check_requests"]


def _cli(cwd):
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "bench.run", "--workload", "gp16k.cold", "--seed", str(2**31 + 3),
                           "--seconds", "1"], cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_cli_refuses_without_the_port_beside_it(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "src/repro_torch" in proc.stderr


def test_cli_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    proc = _cli(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr
