"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``kernels/*/csrc/`` compiles into a shared library with a
plain C interface (the shared headers under ``kernels/csrc/`` included) (no PyTorch headers, so a build takes seconds), placed
under ``build/kernels/`` at the repository root, a directory that
``.gitignore`` lists.  The library name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded.  Nothing is built at import time: ``load(name)`` builds on first
use, on a machine with ``nvcc`` and a Hopper card.

Flags: ``sm_90a``, ``-O3``, no ``--use_fast_math`` and ``--fmad=false``
(the step kernels must round as the op path's separate operations do).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

SOURCES = {
    "engine_step": _PKG / "engine_step" / "csrc" / "engine_step.cu",
    "cc_update": _PKG / "cc_update" / "csrc" / "cc_update.cu",
    "embedding_bag": _PKG / "embedding_bag" / "csrc" / "embedding_bag.cu",
    "flash_decode": _PKG / "flash_decode" / "csrc" / "flash_decode.cu",
}


def headers(src: Path) -> list:
    """The shared headers a source under ``kernels/*/csrc/`` includes (the
    policies' device functions), from the ``kernels/csrc/`` beside it: part
    of its library's hash, so that a copy with other headers (a scratch
    tree of an earlier commit) builds a library of its own."""
    return sorted((Path(src).resolve().parents[2] / "csrc").glob("*.cuh"))


# name -> loaded library; BUILD_INFO[name] -> seconds, nvcc version, ptxas log
_LIBS: dict = {}
BUILD_INFO: dict = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        nvcc = str(cand) if cand.exists() else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built on this machine")
    return nvcc


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else out.strip().splitlines()[-1]


def build(name: str, src: Path | None = None) -> Path:
    """Compile ``SOURCES[name]`` (or ``src`` in its place) unless a
    library of the same source, headers and flags exists; returns the
    library's path."""
    src = SOURCES[name] if src is None else Path(src)
    h = hashlib.sha1(src.read_bytes())
    for hdr in headers(src):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "nvcc": nvcc_version(nvcc),
                        "ptxas": proc.stderr.strip()}
    return lib


def build_all() -> dict:
    """Build every source of ``SOURCES`` at once, one ``nvcc`` process
    each; returns name -> library path."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
