"""Roofline report: three terms for each (arch × shape × mesh) record of the dry-run, on an H100 SXM.

The counterpart of the JAX package's ``launch/roofline.py``; the device
model is ``launch.mesh.H100_SXM`` in place of the TPU v5e:

  compute_s    = FLOPs a rank      / the peak of the cell's compute type
                 (989 TFLOP/s bf16 for the LM cells, 67 TFLOP/s FP32 for the GP cells)
  memory_s     = bytes a rank      / 3.35 TB/s   (unfused bytes: an upper bound on the traffic)
  collective_s = wire bytes a rank / 50 GB/s     (one 400 Gb/s NDR port a GPU)

The counts are the full run's: eager torch runs every layer, so the port's
records mark them ``"corrected": "full"`` (basis "full (every layer)").  A
record of the reference's shape, whose ``corrected`` holds the probes'
trip-count totals, is read from those (basis "probes"); one with neither
falls back to the full run's once-counted numbers (basis "raw(once)").  MODEL_FLOPS = 6·N(_active)·D for train, 2·N·D for
serving; the useful-compute ratio MODEL/counted exposes recomputation and
routing waste.  ``fits`` holds the peak bytes a rank against the device's
80 GB.

Usage:  python -m repro_torch.launch.roofline [--dir build/dryrun] [--csv out.csv] [--mesh pod16x16] [--paired]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.launch.dryrun import OUT_DIR
from repro_torch.launch.mesh import H100_SXM, Hardware


def load_records(d: str) -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def derive(rec: Dict, hw: Hardware = H100_SXM) -> Dict:
    dev = rec.get("devices", 0)
    corrected = rec.get("corrected")
    if isinstance(corrected, dict):
        flops, bytes_, wire = corrected["flops"], corrected["bytes"], corrected["wire_bytes"]
        basis = "probes"
    elif rec.get("full"):
        flops = rec["full"]["cost"]["flops"]
        bytes_ = rec["full"]["cost"]["bytes"]
        wire = rec["full"]["collectives"]["total_wire_bytes"]
        basis = "full (every layer)" if corrected == "full" else "raw(once)"
    else:
        flops = bytes_ = wire = 0.0
        basis = "none"
    dtype = rec.get("compute_dtype", "bfloat16")
    compute_s = hw.compute_seconds(flops, dtype)
    memory_s = hw.memory_seconds(bytes_)
    coll_s = hw.collective_seconds(wire)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    model = rec.get("model_flops", 0.0) / dev if dev else 0.0
    useful = model / flops if flops else 0.0
    # roofline fraction: useful model-compute time over the binding term
    frac = (model / hw.peak_flops(dtype)) / bound if bound else 0.0
    peak = rec["full"]["memory"]["peak_bytes"] if rec.get("full") else None
    return {
        "cell": f"{rec['arch']}×{rec['shape']['name']}",
        "mesh": rec["mesh"],
        "ok": rec.get("ok", False),
        "basis": basis,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "dominant": dominant,
        "model_flops_dev": model,
        "useful_ratio": useful,
        "roofline_frac": frac,
        "peak_gb": peak / 1e9 if peak is not None else None,
        "fits": peak < hw.hbm_bytes if peak is not None else None,
        "error": rec.get("error"),
    }


def markdown_table(rows: List[Dict]) -> str:
    hdr = (
        "| cell | mesh | compute_s | memory_s | collective_s | dominant | "
        "useful MODEL/counted | roofline frac | peak GB/rank | fits 80 GB | basis |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        if not r["ok"]:
            lines.append(f"| {r['cell']} | {r['mesh']} | — | — | — | FAILED: {r['error']} | | | | | |")
            continue
        lines.append(
            f"| {r['cell']} | {r['mesh']} | {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | **{r['dominant']}** | {r['useful_ratio']:.3f} "
            f"| {r['roofline_frac']:.3f} | {r['peak_gb']:.2f} | "
            f"{'✓' if r['fits'] else '✗'} | {r['basis']} |"
        )
    return hdr + "\n".join(lines) + "\n"


def paired_table(rows: List[Dict]) -> str:
    """One line a cell, the (16, 16) and (2, 16, 16) meshes side by side: terms, dominant, useful ratio, peak."""
    def half(r):
        if r is None:
            return "| — " * 7
        if not r["ok"]:
            return f"| FAILED: {r['error']} " + "| " * 6
        return (f"| {r['compute_s']:.3g} | {r['memory_s']:.3g} | {r['collective_s']:.3g} | {r['dominant']} "
                f"| {r['useful_ratio']:.3f} | {r['peak_gb']:.1f} | {'✓' if r['fits'] else '✗'} ")

    by_cell: Dict[str, Dict[str, Dict]] = {}
    for r in rows:
        by_cell.setdefault(r["cell"], {})[r["mesh"]] = r
    cols = "compute_s | memory_s | collective_s | dominant | useful | peak GB | fits 80 GB"
    hdr = f"| cell | (16, 16): {cols} | (2, 16, 16): {cols} |\n" + "|---" * 15 + "|\n"
    lines = [f"| {cell} {half(m.get('pod16x16'))}{half(m.get('pod2x16x16'))}|"
             for cell, m in sorted(by_cell.items())]
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--csv", default=None)
    ap.add_argument("--mesh", default=None, help="filter: pod16x16 | pod2x16x16")
    ap.add_argument("--paired", action="store_true", help="one line a cell, both meshes side by side")
    args = ap.parse_args(argv)
    rows = [derive(r) for r in load_records(args.dir)]
    if args.mesh:
        rows = [r for r in rows if r["mesh"] == args.mesh]
    rows.sort(key=lambda r: (r["mesh"], r["cell"]))
    print(paired_table(rows) if args.paired else markdown_table(rows))
    if args.csv and rows:
        import csv

        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
