"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file compiles on its own with ``nvcc`` into a shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in ``_build/`` beside
this module, named by a hash of the source, the headers next to it and the
flags, so an edited source rebuilds and an unchanged one is loaded as is.
Nothing is built when a module is imported: a wrapper loads its library
when it first launches on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: Path) -> Path:
    """Where ``source`` builds to: keyed by the source, its sibling
    headers and the compiler flags."""
    source = Path(source).resolve()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [source] + sorted(source.parent.glob("*.h")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[Path]) -> Dict[str, float]:
    """Compile every source not yet built, one ``nvcc`` each, all started
    together.  Returns seconds per source built; raises on a failed build.
    The ``-Xptxas -v`` report (registers, spills) goes to ``<lib>.log``."""
    todo = [Path(s).resolve() for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        out = library_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    secs, errors = {}, []
    for src, out, tmp, t0, p in procs:
        log, _ = p.communicate()
        secs[src.name] = time.perf_counter() - t0
        if p.returncode != 0:
            errors.append(f"nvcc failed on {src.name} (rc {p.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def ptxas_report(source: Path) -> List[str]:
    """The register / spill lines ``ptxas -v`` printed for ``source``."""
    log = library_path(source).with_suffix(".log")
    if not log.exists():
        return []
    keep = ("registers", "spill", "Compiling entry")
    return [ln.strip() for ln in log.read_text().splitlines() if any(k in ln for k in keep)]


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed.

    Keyed by ``source`` as given (each wrapper passes its module's
    ``SOURCE``), so a launch does no file-system call: resolving the path
    stats every component, which on a host with slow file-system calls
    takes longer than a short kernel runs."""
    lib = _LIBS.get(source)
    if lib is None:
        path = Path(source).resolve()
        build([path])
        lib = _LIBS[source] = ctypes.CDLL(str(library_path(path)))
    return lib


def stream_ptr(device) -> ctypes.c_void_p:
    """The current PyTorch CUDA stream of ``device``, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


__all__ = ["BUILD_DIR", "build", "library_path", "load", "ptr", "ptxas_report", "stream_ptr"]
