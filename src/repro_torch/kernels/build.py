"""Build and load the port's hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` has a plain C interface and becomes
its own shared library, built by ``nvcc`` for ``sm_90a`` into the
repository's ``build/kernels/`` at first use and loaded with ``ctypes``.
All sources compile in parallel, one ``nvcc`` process each.  A library's
file name carries a digest of its source and flags, so an edited source is
rebuilt and a stale library is never loaded.

The build needs ``nvcc`` (``$CUDA_HOME/bin/nvcc``, else the one on
``PATH``); it is only ever started by a kernel launch on a CUDA tensor or
by :func:`build_all`, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("topk_block", "scatter_agg", "quantize_ef_pack", "unpack_mma",
           "segment_rows", "quantize_ef", "switch_blend")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(force: bool = False) -> dict:
    """Compile every missing kernel library, all ``nvcc`` runs at once.

    Returns ``{name: compiler output}`` for the libraries built by this call
    (``-Xptxas -v`` lists each kernel's registers, shared memory and
    spills).  Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)     # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all kernels first if
    any library is missing)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not library_path(name).exists():
                build_all()
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def launch(name: str, symbol: str, argtypes, args, device) -> None:
    """Call the C launch function ``symbol`` of kernel library ``name`` with
    ``args`` and the current CUDA stream of ``device`` (``argtypes``: the
    ctypes types of ``args``; every pointer a ``c_void_p``, or ctypes would
    pass it as a 32-bit int).  Raises when it returns a CUDA error code --
    a refused launch never runs, and no later synchronize reports it."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with error {rc}")


def rows3(x, kernel: str):
    """``x`` as ``[n, nb, row]``: a 2-D ``[nb, row]`` tensor gains n=1.  The
    inner ``[nb, row]`` must be contiguous (what the kernels index); the
    leading stride is free, so run views of ``[n, d]`` buffers need no
    copy."""
    x3 = x.unsqueeze(0) if x.dim() == 2 else x
    if x3.dim() != 3:
        raise ValueError(f"{kernel}: expected a 2-D or 3-D tensor, got shape "
                         f"{tuple(x.shape)}")
    _, nb, row = x3.shape
    if (nb > 1 and x3.stride(1) != row) or (row > 1 and x3.stride(2) != 1):
        raise ValueError(f"{kernel}: the inner [nb, row] dims must be "
                         f"contiguous, got strides {tuple(x3.stride())}")
    return x3
