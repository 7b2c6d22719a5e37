"""Async, integrity-checked checkpoints (port of
``repro.checkpoint.checkpointer``), in the reference's on-disk format, so
that each side reads the other's files.

Layout:  <dir>/step_<N>/
           manifest.json       — step, extra, and each leaf's shape, dtype,
                                 "viewed" flag and checksum
           shard_0.npz         — the leaves (the reference writes one shard
                                 a host; the port runs on one host)

A leaf's key is its path in the tree, dict keys and list indices joined by
"/" (dict keys in sorted order, as ``jax.tree_util`` flattens), stored in
the npz with "/" -> "__".  numpy has no bfloat16: a bf16 leaf is stored as
its uint16 bits with ``"viewed": true`` (the reference goes through
``ml_dtypes``; the port through a ``torch.int16`` view, so no JAX and no
``ml_dtypes`` is needed).  Each leaf carries ``sha256_16``, the first 16
hex digits of the sha256 of its stored bytes; ``restore`` raises on a
checksum or a shape mismatch, so a truncated or corrupt file fails loudly.

Leaves are torch tensors (on any device), numpy arrays or python numbers.
``save`` copies every leaf to host memory before its writer thread
starts: the trainer updates weights in place, and a pending save must not
see the next step.  Writes are atomic (a tmp dir, then a rename) and
asynchronous (a thread); ``wait()`` joins the writer and raises what it
raised.  The newest ``keep`` steps are kept.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    list items in order, keys joined by "/"."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix[:-1], tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, f"{prefix}{k}/"))
    return out


def _rebuild(tree, values: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[key]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return values[prefix[:-1]]


def _to_host(leaf) -> Tuple[np.ndarray, bool]:
    """A host copy of ``leaf`` as numpy, and whether it is bf16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).to("cpu", copy=True).numpy()
                    .view(np.uint16), True)
        return t.to("cpu", copy=True).numpy(), False
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":          # an ml_dtypes array
        return arr.view(np.uint16), True
    return arr, False


def host_leaves(tree) -> Dict[str, np.ndarray]:
    """Each leaf of ``tree`` as ``save`` stores it (a host copy; bf16 as
    its uint16 bits), keyed as the manifest keys it."""
    return {k: _to_host(v)[0] for k, v in _flatten(tree)}


def _from_host(arr: np.ndarray, viewed: bool, like):
    """A restored leaf in the kind of ``like``: a CPU tensor for a tensor
    (in the stored dtype; bf16 bits as bfloat16), an array for an array,
    a number for a number."""
    if isinstance(like, torch.Tensor):
        if viewed:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)
    if isinstance(like, np.ndarray):
        return arr.view(like.dtype) if viewed else arr
    return arr.item()


def _shape(like) -> List[int]:
    return list(getattr(like, "shape", ()))


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def _hasher() -> ThreadPoolExecutor:
    """Threads for the leaves' checksums: hashlib releases the GIL on
    large buffers, so the leaves hash side by side (and beside the npz
    write)."""
    return ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


class Checkpointer:
    """``save`` / ``restore`` of a tree of leaves under ``directory``
    (module docstring).  ``timings`` holds the last save's host-copy and
    write seconds and bytes, and the last restore's seconds."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self.timings: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Dict, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        t0 = time.perf_counter()
        host = [(k, *_to_host(v)) for k, v in _flatten(tree)]
        self.timings["snapshot_s"] = time.perf_counter() - t0
        self.timings["bytes"] = sum(a.nbytes for _, a, _ in host)

        def write():
            t1 = time.perf_counter()
            tmp = os.path.join(self.dir, f".tmp_step_{step}_0")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            with _hasher() as pool:
                digests = [pool.submit(_digest, a) for _, a, _ in host]
                np.savez(os.path.join(tmp, "shard_0.npz"),
                         **{k.replace("/", "__"): a for k, a, _ in host})
                manifest = {
                    "step": step,
                    "extra": extra or {},
                    "num_hosts": 1,
                    "leaves": {k: {"shape": list(a.shape),
                                   "dtype": str(a.dtype), "viewed": viewed,
                                   "sha256_16": d.result()}
                               for (k, a, viewed), d in zip(host, digests)},
                }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
            self.timings["write_s"] = time.perf_counter() - t1

        if blocking:
            write()
            return

        def run():
            try:
                write()
            except BaseException as e:      # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def wait(self) -> None:
        """Join the pending writer; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise IOError(f"checkpoint write failed: {err!r}") from err

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Dict, step: Optional[int] = None
                ) -> Tuple[Dict, int, Dict]:
        """Restore into the structure of ``tree_like`` (the latest step by
        default), checking every leaf's checksum and shape.  Returns
        (tree, step, extra); a tensor leaf comes back as a CPU tensor in
        the stored dtype (``_from_host``)."""
        self.wait()
        t0 = time.perf_counter()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        likes = _flatten(tree_like)
        with np.load(os.path.join(path, "shard_0.npz")) as data, \
                _hasher() as pool:
            arrays = {k: data[k.replace("/", "__")] for k, _ in likes}
            digests = {k: pool.submit(_digest, a) for k, a in arrays.items()}
        values = {}
        for k, like in likes:
            arr, meta = arrays[k], manifest["leaves"][k]
            if digests[k].result() != meta["sha256_16"]:
                raise IOError(f"checkpoint corruption in leaf {k} "
                              f"(checksum mismatch)")
            if list(arr.shape) != _shape(like):
                raise ValueError(f"leaf {k}: checkpoint shape {arr.shape} "
                                 f"!= expected {tuple(_shape(like))}")
            values[k] = _from_host(arr, meta.get("viewed", False), like)
        self.timings["restore_s"] = time.perf_counter() - t0
        return (_rebuild(tree_like, values), manifest["step"],
                manifest.get("extra", {}))
