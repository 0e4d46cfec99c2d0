"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Every ``*.cu`` file under ``csrc/`` is compiled with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together) and linked
into one shared library with a plain ``extern "C"`` interface, which
:mod:`ctypes` loads. The build happens at first use, never at import:
:func:`library` builds into ``build/repro_torch/<hash>/`` at the
repository root, keyed by a hash of the sources and flags, so a rebuilt
source gets a fresh directory and an unchanged tree reuses the library.
A thread lock and a file lock guard the build: the thread backend, the
background compile pipeline and concurrent processes can all reach the
first miss at once, and exactly one of them compiles.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import torch

__all__ = ["BUILD_ROOT", "CSRC", "NVCC_FLAGS", "current_stream_ptr",
           "kernel_fn", "library", "library_path", "source_hash"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libreprotorch.so"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FNS: dict[str, object] = {}
#: the current stream's raw ``cudaStream_t`` of a device index, without
#: building a ``torch.cuda.Stream`` object per launch (CUDA builds of torch
#: export it; the public path below is the fallback)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every kernel source (``*.cu``, ``*.cuh``) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    return BUILD_ROOT / source_hash() / LIB_NAME


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this host")


def _run_all(cmds: Sequence[Sequence[str]]) -> list[str]:
    """Run commands in parallel; raise with the output of any failure."""
    procs = [subprocess.Popen(list(cmd), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return outs


def _build(so: Path) -> None:
    nvcc = _nvcc()
    out_dir = so.parent
    t0 = time.perf_counter()
    objs = [out_dir / (src.stem + ".o") for src in _sources()]
    logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                     for src, obj in zip(_sources(), objs)])
    tmp = out_dir / (LIB_NAME + ".tmp")
    logs += _run_all([[nvcc, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
    os.replace(tmp, so)
    (out_dir / "build.log").write_text(
        f"built in {time.perf_counter() - t0:.3f}s\n" + "\n".join(logs),
        encoding="utf-8")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call in a tree."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = library_path()
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            with open(so.parent / "build.lock", "w") as lock:
                fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
                try:
                    if not so.exists():   # another process may have won
                        _build(so)
                finally:
                    fcntl.flock(lock.fileno(), fcntl.LOCK_UN)
        _LIB = ctypes.CDLL(str(so))
        return _LIB


def kernel_fn(name: str, argtypes: Sequence[type]):
    """The library's ``extern "C"`` launcher ``name`` with its argument
    types declared (pointers and the stream as ``c_void_p``, sizes as
    ``c_int64``); every launcher returns ``cudaGetLastError()`` as int."""
    fn = _FNS.get(name)
    if fn is None:
        lib = library()
        with _LOCK:
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FNS[name] = fn
    return fn


def current_stream_ptr(index: int) -> int:
    """The raw ``cudaStream_t`` of device ``index``'s current stream (the
    stream a launch must enqueue on, graph capture included)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream
