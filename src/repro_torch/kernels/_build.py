"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so`` beside this
file (listed in .gitignore), compiled for Hopper (``sm_90a``) with a plain C
interface.  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused.  :func:`build` starts one nvcc per missing
library, all at once (each one's time in ``build_seconds``); :func:`library`
builds on first use.  Nothing is built or loaded when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["SOURCES", "KernelBuildError", "build", "header_int", "library", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("field", "plateau", "plateau_pregen", "popcount")
# --split-compile=0 optimizes a source's kernels in parallel on every core:
# each source holds one kernel per J type, vector-load choice and mode.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--split-compile=0",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """A CUDA source could not be built: no nvcc, or nvcc failed."""


_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Seconds from the start of the last build() that compiled a source to the
# end of that source's nvcc, by source.
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(repr(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, in parallel.

    Each library is written to a temporary file and renamed into place, so
    concurrent builds never load a half-written library.  Raises with
    nvcc's output if a compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in names}
    procs = {}
    t0 = time.monotonic()
    for name, path in paths.items():
        if path.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        log = open(path.with_suffix(".log"), "w")
        procs[name] = (tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
    failed = []
    while procs:
        for name, (tmp, log, proc) in list(procs.items()):
            if proc.poll() is None:
                continue
            build_seconds[name] = time.monotonic() - t0
            log.close()
            del procs[name]
            if proc.returncode != 0:
                out = paths[name].with_suffix(".log").read_text()
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
                os.unlink(tmp)
            else:
                os.replace(tmp, paths[name])
        time.sleep(0.05)
    if failed:
        raise KernelBuildError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def header_int(header: str, name: str) -> int:
    """The value of ``constexpr int <name> = <value>;`` in ``csrc/<header>``,
    so that a limit the kernels hold is written down once."""
    text = (CSRC / header).read_text()
    found = re.search(rf"^constexpr int {name} = (\d+);", text, re.M)
    if found is None:
        raise RuntimeError(f"csrc/{header} defines no constexpr int {name}")
    return int(found.group(1))


def ptxas_report(name: str) -> str:
    """What nvcc/ptxas printed for a built library (registers, spills, smem)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
