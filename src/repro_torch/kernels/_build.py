"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a plain
C interface, loaded with ``ctypes``; no PyTorch header is included, which
keeps a build to seconds. The libraries land in ``src/repro_torch/_build/``
under a name keyed by a hash of the source, the shared headers (``*.cuh``)
and the flags, so an edited source or header rebuilds and an unchanged one is
reused. ``VARIANTS`` names further builds of a source with extra defines
(probes that ``chip_smoke.py`` times beside a kernel). The first call builds
every source and variant at once, one ``nvcc`` process each, all started
together.

Nothing here runs at import: ``nvcc`` is looked up, and the sources built,
only when a wrapper first launches a kernel on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> (source stem, extra nvcc flags)
VARIANTS = {"nm_spmm_broadcast": ("nm_spmm", ("-DNM_SPMM_BROADCAST",))}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the repro_torch kernels")


def _spec(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source and the full flags of library ``name``."""
    stem, extra = VARIANTS.get(name, (name, ()))
    return SRC_DIR / f"{stem}.cu", NVCC_FLAGS + extra


def _target(name: str) -> Path:
    """The library ``name``, named by a hash of its source, every shared
    header in ``csrc/`` (a source may include any of them) and the flags."""
    src, flags = _spec(name)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source and variant whose library is missing; returns
    the seconds spent. The compiler's report (registers, shared memory,
    spills from ``-Xptxas -v``) is kept beside each library as
    ``<name>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    stems = [src.stem for src in sorted(SRC_DIR.glob("*.cu"))]
    for name in stems + list(VARIANTS):
        out = _target(name)
        if out.exists():
            continue
        src, flags = _spec(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's report for library ``name`` (after ``build_all``)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``csrc/<name>.cu`` or a variant), built
    on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = _target(name)
        if not path.exists():
            build_all()
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry reported a CUDA error (its ``cudaGetLastError``)."""
    if code:
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name}: CUDA error {code}: "
                           f"{err(code).decode()}")
