"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``.  Pointers and the
stream are passed as ``c_void_p``, shapes as ``c_int``.  Every launch entry
returns ``cudaGetLastError()``; :func:`check` raises on anything but 0.

The build happens at first use, never at import: the CPU tests import
every module on machines without ``nvcc``.  Libraries go to ``build/`` at
the repository root (git-ignored) under a name keyed by the hash of the
sources and flags, so an edited kernel is rebuilt and a stale library is
never loaded.  All missing sources are compiled together, one ``nvcc``
process each, started at once.

Launch counters live here too: each wrapper adds one to its entry of
:data:`LAUNCHES` where it launches its kernel, and nowhere else, so a run
can show that its main path went through the kernels.  So does
:func:`no_backward`, the guard of the wrappers whose kernels have no
backward.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("spmm", "spmm_bwd", "halo_pull", "flash_attention",
           "gat_edge")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Storage dtype codes of csrc/common.cuh::StorageDtype.
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2}

LAUNCHES = {"spmm": 0, "halo_spmm": 0, "halo_spmm_stream": 0,
            "halo_spmm_skip": 0, "spmm_bwd_table": 0, "spmm_bwd_wts": 0,
            "flash_attention": 0, "gat_edge_partial": 0}

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], object] = {}


def dtype_code(dtype) -> int:
    """Storage dtype code of a torch dtype (csrc/common.cuh)."""
    return DTYPE_CODES[str(dtype).split(".")[-1]]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "CUDA_HOME); the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every source of ``names`` whose library is missing, all in
    parallel.  Returns ``{name: {"path", "seconds", "log"}}`` for the
    sources it compiled (``seconds`` is that source's own ``nvcc`` wall
    time; ``log`` holds ptxas's register and spill report); raises with the
    compiler's output if any build fails."""
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, target in todo.items():
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        log = tmp.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            procs[name] = (tmp, log, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT, text=True))
    out, failed, seconds = {}, [], {}
    while len(seconds) < len(procs):
        for name, (_, _, proc) in procs.items():
            if name not in seconds and proc.poll() is not None:
                seconds[name] = time.perf_counter() - t0
        time.sleep(0.02)
    for name, (tmp, log_path, proc) in procs.items():
        log = log_path.read_text()
        log_path.unlink()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, todo[name])
        out[name] = {"path": str(todo[name]), "seconds": seconds[name],
                     "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every missing
    library first."""
    lib = _LIBS.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_target(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def kernel_fn(source: str, symbol: str, argtypes: list):
    """C launch entry ``symbol`` of ``source`` with its ctypes signature
    declared (``restype`` is the returned cudaError_t code)."""
    fn = _FNS.get((source, symbol))
    if fn is None:
        fn = getattr(library(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(source, symbol)] = fn
    return fn


def check(code: int, source: str, what: str) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if code != 0:
        msg = library(source).kernel_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch(fn, t, *args) -> int:
    """Call the C launch entry ``fn`` with ``args`` and the current stream
    of tensor ``t``'s card, with that card current; returns its code."""
    import torch
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(*args, ctypes.c_void_p(stream))


def no_backward(what: str, *tensors, hint: str) -> None:
    """Raise on an input that requires grad while grad mode is on: the
    kernel has no backward, and a result cut off from autograd would drop
    gradients silently.  The wrappers check this on every device, so a
    loss that trains on the CPU does not lose its gradients on the card."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward: {hint}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor, or NULL for None."""
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)
