"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
All missing libraries are built at once, one ``nvcc`` process per source
started together.  A library's file name carries a hash of its source, the
shared headers and the flags, so an edited source is rebuilt and a stale
library is never loaded.  The libraries go to ``build/repro_torch/`` at the
root of the checkout (git-ignored).  A missing ``nvcc`` or a failed build
raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = (
    "cov_assembly", "potrf_tile", "trsm_tile", "trailing_update", "carry_update", "lrgemm_tile",
    "flash_attention", "tile_gemv_trsv",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the default toolkit."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Content-addressed path of the shared library built from ``csrc/<name>.cu``."""
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{name: library path}``.  The compiler's output (``-Xptxas -v``:
    registers, shared memory and spills of each kernel) is kept beside each
    library as ``<library>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failures = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        paths[name].with_suffix(".so.log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def build_log(name: str) -> str:
    """The compiler's output for ``csrc/<name>.cu`` (after a build)."""
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all sources if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                if n not in _libs:
                    _libs[n] = _bind(ctypes.CDLL(str(p)))
            lib = _libs[name]
        return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
_SIGNATURES = {
    "cov_tiles": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P],
    "potrf": [_P, _P, _P, _P, _I, _I, _I, _P],
    "trsm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "trail": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "carry_update": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "lrgemm": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _P],
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _D, _D, _I, _I, _I, _P],
    "tile_gemv": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    "tile_trsv": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _P],
}


# launch-geometry queries some libraries export: (name, argtypes, restype)
_QUERIES = (
    ("carry_update_f32_ctas_per_sm", [_I], _I),
    ("cov_tiles_f32_ctas_per_sm", [_I], _I),
    ("cov_tiles_limits", [_I], _I),
    ("carry_update_f32_strip", [_I], _I),
    ("carry_update_max_m", [_I], _I),
    ("flash_bf16_ctas_per_sm", [_I], _I),
    ("trail_f32_ctas_per_sm", [_I], _I),
    ("trsm_depth", [_I, _I, _I], _I),
    ("trsm_max_m", [_I], _I),
    ("trsm_strip", [_L, _I, _I, _I], _I),
    ("tile_gemv_variant", [_P, _P, _I, _I, _P, _P, _I], _I),
    ("tile_gemv_ctas_per_sm", [_I, _I], _I),
    ("tile_trsv_plan", [_I, _I, _I], _I),
    ("tile_trsv_occupancy", [_I, _I, _I, _I], _I),
)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare argtypes/restype of every launcher the library exports."""
    lib.repro_error_string.argtypes = [_I]
    lib.repro_error_string.restype = ctypes.c_char_p
    for name, argtypes, restype in _QUERIES:
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype
    for base, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64", "bf16"):
            fn = getattr(lib, f"{base}_{suffix}", None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = _I
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
