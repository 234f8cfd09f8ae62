"""Nothing the benchmark loads is JAX or the JAX package; the reference loads nothing of the port."""

import ast
import json
import subprocess
import sys

from bench.tests.tiny import BENCH, ROOT, SRC

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(
    "bench." + ".".join(p.relative_to(BENCH).with_suffix("").parts)
    for p in BENCH.rglob("*.py") if "tests" not in p.parts and p.name != "__init__.py"
)


def loaded_after(modules):
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]\n"
        f"for m in {modules!r}: __import__(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout)


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    # with what bench/program.py loads when a run first calls the port; a run itself refuses to print a
    # result when a forbidden module is loaded by the time its window closes (harness.forbidden_modules)
    tops = {m.split(".")[0] for m in loaded_after(MODULES + ["repro_torch.core", "repro_torch.obs", "repro_torch.kernels._build"])}
    assert "repro_torch" in tops  # the port is loaded, and its name is not the JAX package's
    assert not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    refs = [m for m in MODULES if m.startswith("bench.reference")]
    loaded = loaded_after(refs)
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN | {"repro_torch"} or m == "bench.program"]


def test_the_reference_imports_name_nothing_of_the_port():
    for p in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"repro_torch"} and not n.startswith("bench.program"), (p, n)


def test_the_forbidden_check_compares_whole_names():
    sys.path[:0] = [str(ROOT)]
    from bench import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
    sys.modules.setdefault("repro_torch_lookalike", sys)
    assert "repro_torch_lookalike".split(".")[0] not in harness.forbidden_modules()
    assert json.loads(json.dumps(harness.forbidden_modules())) == []
