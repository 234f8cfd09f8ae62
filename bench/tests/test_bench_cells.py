"""Each cell of BENCHMARK.json end to end at a tiny size on the CPU, through the port's plain versions."""

import json

import pytest

from bench.tests.tiny import ROOT, run_tiny

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_prints_the_contract_line(tiny_root, cell):
    out = run_tiny(tiny_root, cell)
    line = out["line"]
    assert list(line) == CONTRACT + ["checks"]  # the compared numbers come last
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], name
    # the numbers compared are the last lines on stderr, each beside its limit
    tail = out["stderr"].strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_traced_run_reports_per_layer_metrics_and_breakdown(tiny_root):
    line = run_tiny(tiny_root, "gp16k.warm", trace=True)["line"]
    assert list(line) == CONTRACT + ["breakdown", "checks"]
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # on the CPU no operation runs on a device: the readers that need the card or its peaks read nothing
    assert "roofline.warm" not in line["metrics"] and "mfu.warm" not in line["metrics"]


TELEMETRY_SEEN = """
import atexit, sys
from repro_torch import obs
from repro_torch.core import GaussianProcess
_predict = GaussianProcess.predict
seen = []
def predict(self, x):
    seen.append(obs.enabled())
    return _predict(self, x)
GaussianProcess.predict = predict
atexit.register(lambda: print("TELEMETRY", seen.count(True), seen.count(False), file=sys.stderr))
"""


def test_telemetry_is_off_in_the_window_and_on_for_the_check_requests(tiny_root):
    out = run_tiny(tiny_root, "gp16k.cold", patch=TELEMETRY_SEEN)
    on, off = map(int, next(t for t in out["stderr"].splitlines() if t.startswith("TELEMETRY")).split()[1:])
    mix = json.loads((tiny_root / "bench" / "traffic" / "cold.json").read_text())
    assert on == mix["check_requests"]
    assert off == mix["warmup_requests"] + out["line"]["attempted"] - mix["check_requests"]


def test_a_configuration_asking_for_tf32_is_refused(tmp_path):
    from bench.tests.tiny import make_tiny_copy

    root = make_tiny_copy(tmp_path)
    f = root / "bench" / "configs" / "gp_16k.json"
    f.write_text(json.dumps({**json.loads(f.read_text()), "tf32": True}))
    with pytest.raises(AssertionError, match="TF32"):
        run_tiny(root, "gp16k.cold")
