"""Build the CUDA kernels under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/*.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc`` per source compiles in seconds.  The sources are compiled in
parallel for ``sm_90a`` (Hopper), linked into
``build/kernels/libseifer_kernels.so`` at the repository root, and loaded
once per process at the first CUDA use.  A stamp of the sources' hash sits
beside the library, so an unchanged checkout loads without rebuilding.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers call ``check`` on it.  A failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libseifer_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of every C entry point: c_void_p for each pointer and the stream
SIGNATURES = {
    "seifer_quantize_int8": [_P, _I, _P, _P, _L, _I, _I, _I, _P],
    "seifer_dequantize_int8": [_P, _P, _P, _I, _L, _I, _I, _I, _P],
    "seifer_dequant_matmul": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P],
    "seifer_flash_attention_fwd": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _I, _I, _F, _F, _P,
    ],
    "seifer_flash_attention_bwd": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _L, _L, _L, _L, _L, _L, _I, _I, _F, _F, _P,
    ],
    "seifer_ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "seifer_ssd_scan_bwd": [*[_P] * 16, _I, _I, _I, _I, _I, _I, _P],
    "seifer_gemm_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
}

_lib = None
build_log = ""  # ptxas -v output of the last build (registers, smem, spills)
build_seconds: dict[str, float] = {}  # wall seconds of each source's nvcc in the last build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256()
    for p in sources + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()


def build(force: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, all at once) and link
    them into the shared library; returns its path."""
    global build_log
    sources = _sources()
    digest = _digest(sources)
    lib_path = BUILD / LIB_NAME
    stamp = BUILD / (LIB_NAME + ".sha256")
    if (not force and lib_path.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return lib_path
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs, procs = [], {}
        t0 = time.perf_counter()
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            with open(Path(tmp) / (src.stem + ".log"), "w") as log:
                procs[src] = subprocess.Popen(
                    [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=log, stderr=subprocess.STDOUT)
        build_seconds.clear()
        while len(build_seconds) < len(procs):  # each one's own time, all in parallel
            for src, proc in procs.items():
                if src.name not in build_seconds and proc.poll() is not None:
                    build_seconds[src.name] = time.perf_counter() - t0
            time.sleep(0.05)
        logs, failed = [], []
        for src, proc in procs.items():
            logs.append(f"== {src.name}\n{(Path(tmp) / (src.stem + '.log')).read_text()}")
            if proc.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builders never see half a file
    stamp.write_text(digest)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call in a process)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
