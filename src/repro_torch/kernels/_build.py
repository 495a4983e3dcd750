"""Build and load the port's CUDA kernels.

Each source in ``src/repro_torch/csrc/*.cu`` becomes its own shared library
with a plain C interface, compiled by ``nvcc`` for ``sm_90a`` and loaded with
``ctypes``.  No PyTorch header is included, so a build takes seconds.  The
libraries go to ``build/repro_torch/`` at the root of the checkout, named by
a hash of every source and header in ``csrc/`` and the flags, so a changed
source is rebuilt and an unchanged one is loaded as it is.

Nothing is built at import: the first kernel launch on a CUDA tensor calls
``library(name)``, which builds all sources (one ``nvcc`` process each, run
together) unless they are already built.  A missing ``nvcc`` or a failed
build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("quant_act", "int8_gemm", "paged_decode", "flash_attention",
           "flash_attention_bwd")

# no --use_fast_math: the kernels rely on IEEE division and rint rounding
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the launchers: pointers and the stream as c_void_p
SIGNATURES = {
    "quant_act": {
        "launch_quant_act": [_P] * 6 + [_I] * 12 + [_P],
    },
    "int8_gemm": {
        "launch_tiled_matmul": [_P] * 7 + [_I] * 9 + [_P],
        "launch_fused_qkv": [_P] * 12 + [_I] * 10 + [_P],
        "launch_tiled_matmul_int32": [_P] * 6 + [_I] * 7 + [_P],
        "launch_int8_epilogue": [_P] * 5 + [_I] * 4 + [_P],
    },
    "paged_decode": {
        "launch_paged_decode": [_P] * 10 + [_I] * 11 + [_F, _F] + [_I] * 3 + [_P],
    },
    "flash_attention": {
        "launch_flash_attention": [_P] * 6 + [_I] * 8 + [_F, _F] + [_I] * 2 + [_P],
    },
    "flash_attention_bwd": {
        "launch_flash_attention_bwd": [_P] * 10 + [_I] * 8 + [_F, _F] + [_I] * 2
        + [_P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``; raises if none exists."""
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
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def ptxas_log(name: str) -> str:
    """What ``-Xptxas -v`` printed when ``name`` was built."""
    return library_path(name).with_suffix(".log").read_text()


def build() -> dict[str, Path]:
    """Compile every source that is not built yet, all at once; returns the
    library path of each source."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{out}")
            continue
        todo[name].with_suffix(".log").write_text(out)
        os.replace(tmp, todo[name])     # atomic: a reader sees all or none
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build()[name]))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
