"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (the GEMM kernels share
``csrc/gemm_tile.cuh``).  ``load(name)`` compiles it with ``nvcc`` for
``sm_90a`` into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), keyed by a hash of the source, the headers and the flags,
and returns the loaded library.  The build runs only when a kernel is
first launched: importing this module needs no ``nvcc`` and no GPU.
``count_launch`` and ``refuse_grad`` are the wrappers' shared bookkeeping.
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()
_LOAD_LOCK = threading.Lock()      # the ranks' threads build at first use


def count_launch(fn, attr: str = "launches") -> None:
    """``fn.<attr> += 1`` under a lock: the wrappers' launch counts stay
    exact when the ranks of a ``dist.RankGroup`` launch from their own
    threads (a bare ``+=`` on an attribute can lose counts between
    threads)."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)


def refuse_grad(kernel: str, item: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and one of
    ``tensors`` (None is skipped) requires grad.  The kernels have no
    backward: an output they fill through ctypes carries no ``grad_fn``, so
    a backward pass would skip the op and raise nothing.  ``item`` is the
    ROADMAP queue 1 item that brings the backward."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{kernel}: the CUDA kernel has no backward (ROADMAP queue 1 "
            f"item {item}); call it under torch.no_grad() or with inputs "
            "that do not require grad")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda"
                       "/bin): the port's kernels are built at first use")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, keyed by its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source's library exists.  The
    compiler's report (registers, shared memory, spills from ``-Xptxas -v``)
    is kept beside the library as ``.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) for {name}.cu:\n"
                           f"{res.stdout}\n{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)        # atomic: concurrent builders agree
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first call)."""
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LOADED[name] = lib
    return lib
