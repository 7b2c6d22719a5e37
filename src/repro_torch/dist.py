"""The rank group: n tensor-parallel ranks in one process, one thread each.

The port's counterpart of the reference's ``compat.shard_map`` over forced
host devices (``tests/conftest.py:run_subprocess_devices``).  ``RankGroup(n,
device)`` runs one function per rank (``group.spmd(fn, per_rank_args)``):
rank ``r`` runs on its own thread with a thread-local rank index and, on a
CUDA device, its own stream, so the ranks' kernels run at the same time.
All ranks share the one device, which is the FLUX "peer pointer" model
with every peer on the same card: a peer's buffer is an address this rank
reads directly, ordered by CUDA events, with no NCCL.

What the ranks share:

* ``publish(x)`` — every rank posts a tensor and an event recorded on its
  stream after the tensor was produced; after the barrier every rank holds
  all ranks' (tensor, event) pairs.  ``exchange`` / ``ppermute`` /
  ``all_gather`` build on it: the reader's stream waits on the owner's
  event before it reads, and the tensor is kept alive for the reader's
  stream (``record_stream``).
* ``symmetric(name, shape, dtype)`` — one buffer per rank, every rank sees
  all of them, cached per (name, shape, dtype) like FLUX's workspace.
* ``barrier(what)`` — bounded by ``timeout_s``: on timeout every rank is
  aborted and the error names the waiting rank, the collective and where
  the missing ranks were.  An exception in one rank aborts the others and
  is raised to the caller of ``spmd``.

On CPU tensors the same group runs, with no streams or events.  cuBLAS
keeps a workspace (33.5 MB on the H100) for every (handle, stream) pair
that ran a GEMM, for the life of the process, and the rank threads of
each ``spmd`` take the pooled handles in a varying order: ``spmd``
releases them all when its ranks return (``release_gemm_workspaces``;
the caching allocator keeps the blocks for the next calls).  All ranks
sit on one device; placing rank i on card i is not written yet (ROADMAP
queue 1 item 2).

``RankMesh(shape, axes, device)`` is the port's counterpart of a
multi-axis ``jax.sharding.Mesh`` (``launch.mesh.make_mesh``): one thread
and one stream pair per rank, ranks numbered row-major over ``shape``.
Each rank sees one sub-group per axis, the ranks that share every other
coordinate: a ``RankGroup`` view (``mesh.group(axis)``) with its own
barrier, slots, symmetric buffers and flag epochs over the mesh's threads
and streams, so two TP groups of one mesh never share a flag array.
Inside a mesh rank ``current_group()`` is the rank's "model" sub-group.
``mesh.group(("data", "model"))`` is the view over several axes at once
(the experts' group under ``ep_over_dp``), its ranks in the reference's
axis-major order: index ``data · tp + model``.  One rank's failure
aborts every sub-group's barrier.  ``RankGroup(n,
device)`` is the one-axis case and runs its own ``spmd``; a view runs
inside its mesh's.
"""
from __future__ import annotations

import itertools
import math
import sys
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

DEFAULT_TIMEOUT_S = 120.0
# cyclic flag epochs: a flag written in call e holds (e % EPOCHS) + 1, so a
# slot never needs a reset and a stale value never equals the next one
EPOCHS = 1 << 20
# the interpreter's thread switch interval while ranks run: the ranks take
# turns on the GIL at every barrier, and the default 5 ms slice would make
# each turn wait up to a slice per rank
SWITCH_INTERVAL_S = 1e-4

_LOCAL = threading.local()


def release_gemm_workspaces() -> None:
    """Free cuBLAS's workspaces of every (handle, stream) pair (module
    docstring); the next GEMM on a stream takes one again."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


class RankGroupError(RuntimeError):
    """A rank failed, or a barrier timed out."""


def current_group() -> Optional["RankGroup"]:
    """The group whose rank thread is running (a mesh rank's "model"
    sub-group), or None outside ``spmd``."""
    return getattr(_LOCAL, "group", None)


def _walk_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        fn(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _walk_tensors(o, fn)
    elif isinstance(obj, dict):
        for o in obj.values():
            _walk_tensors(o, fn)


def clone(x):
    """A copy of a tensor, or a tuple of copies of a tuple's tensors."""
    if isinstance(x, tuple):
        return tuple(t.clone() for t in x)
    return x.clone()


class _Ranks:
    """What runs ranks: ``spmd`` over ``n`` threads.  A subclass names the
    thread's rank (``_enter`` / ``_leave``), the barriers a failure
    aborts (``_groups``) and the streams (``_streams``)."""

    n: int
    device: torch.device
    cuda: bool
    timeout_s: float

    def _groups(self) -> List["RankGroup"]:
        raise NotImplementedError

    def _enter(self, r: int) -> None:
        raise NotImplementedError

    def _done(self, r: int) -> None:
        raise NotImplementedError

    def _leave(self) -> None:
        _LOCAL.group = None
        _LOCAL.mesh = None

    def spmd(self, fn: Callable, per_rank_args: Sequence[Sequence[Any]]
             ) -> List[Any]:
        """Run ``fn(*per_rank_args[r])`` as rank r, all ranks at once;
        return the n results in rank order.  On CUDA each rank's stream
        first waits for the caller's stream, and the caller's stream waits
        for every rank's at the end.  The first failing rank's exception is
        raised (a rank that failed first outranks ranks whose barrier it
        broke); a failure aborts every barrier of the ranks."""
        if len(per_rank_args) != self.n:
            raise ValueError(f"spmd: {len(per_rank_args)} argument sets for "
                             f"{self.n} ranks")
        if current_group() is not None or getattr(_LOCAL, "mesh", None):
            raise RankGroupError("spmd cannot nest inside a rank")
        results: List[Any] = [None] * self.n
        errors: List[Optional[BaseException]] = [None] * self.n
        start = done = None
        if self.cuda:
            start = torch.cuda.current_stream(self.device).record_event()
            done = [None] * self.n

        def abort():
            for g in self._groups():
                g._barrier.abort()

        def body(r: int):
            self._enter(r)
            try:
                if self.cuda:
                    torch.cuda.set_device(self.device)
                    st = self._streams[r]
                    st.wait_event(start)
                    with torch.cuda.stream(st):
                        results[r] = fn(*per_rank_args[r])
                        done[r] = st.record_event()
                else:
                    results[r] = fn(*per_rank_args[r])
            except BaseException as e:      # re-raised by the caller below
                errors[r] = e
                abort()
            finally:
                self._done(r)
                self._leave()

        threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                    name=f"rank{r}") for r in range(self.n)]
        switch = sys.getswitchinterval()
        sys.setswitchinterval(min(switch, SWITCH_INTERVAL_S))
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(self.timeout_s * 4)
        finally:
            sys.setswitchinterval(switch)
        alive = [r for r, t in enumerate(threads) if t.is_alive()]
        if alive:
            abort()
            raise RankGroupError(f"ranks {alive} still running after "
                                 f"{self.timeout_s * 4} s")
        for g in self._groups():
            # the last exchanges' slots would keep what they carried (a
            # step's grads) alive until the next run
            g._slots = [[None] * g.n, [None] * g.n]
        failed = [r for r in range(self.n) if errors[r] is not None]
        if failed:
            for g in self._groups():
                g._barrier.reset()
                g._gen = [0] * g.n
            first = next((r for r in failed
                          if not isinstance(errors[r], _BrokenBarrier)),
                         failed[0])
            raise RankGroupError(f"rank {first} failed: {errors[first]!r}"
                                 ) from errors[first]
        if self.cuda:
            caller = torch.cuda.current_stream(self.device)
            for ev in done:
                caller.wait_event(ev)
            _walk_tensors(results, lambda t: t.record_stream(caller)
                          if t.is_cuda else None)
            release_gemm_workspaces()
        return results


class RankGroup(_Ranks):
    """n ranks on one device, one thread and (on CUDA) two streams each:
    ``stream(r)`` runs the rank's work, ``comm_stream(r)`` its peer copies
    (the AG-GEMM's pulls).  ``share`` is the number of ranks that run on
    the card at once (n; a mesh sub-group's is the mesh's size): the fused
    kernels size their persistent grids by it."""

    def __init__(self, n: int, device=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if n < 1:
            raise ValueError(f"a rank group needs n >= 1 ranks, got {n}")
        self._setup(n, resolve_device(device), timeout_s)
        self._mesh = None
        self.share = n
        if self.cuda:
            self._streams = [torch.cuda.Stream(self.device) for _ in range(n)]
            self._comm = [torch.cuda.Stream(self.device) for _ in range(n)]

    def _setup(self, n: int, device: torch.device, timeout_s: float) -> None:
        self.n = n
        self.device = device
        self.timeout_s = timeout_s
        self._barrier = threading.Barrier(n)
        self._slots: List[List[Any]] = [[None] * n, [None] * n]
        self._gen = [0] * n                 # per-rank exchange generation
        self._where: List[str] = ["idle"] * n
        self._lock = threading.Lock()
        self._sym: Dict[Tuple, List[torch.Tensor]] = {}
        self._epoch = [0] * n
        self.cuda = self.device.type == "cuda"

    @classmethod
    def _view(cls, mesh: "RankMesh", members: Sequence[int]) -> "RankGroup":
        """The sub-group of ``mesh`` over its ranks ``members`` (in this
        group's rank order): its own barrier, slots, buffers and epochs,
        the mesh's threads and streams."""
        g = cls.__new__(cls)
        g._setup(len(members), mesh.device, mesh.timeout_s)
        # weak: the mesh holds its views, and a cycle would keep a dropped
        # mesh's symmetric buffers until the cyclic collector ran
        g._mesh = weakref.ref(mesh)
        g.share = mesh.size
        g._index = {m: i for i, m in enumerate(members)}
        if g.cuda:
            g._streams = [mesh._streams[m] for m in members]
            g._comm = [mesh._comm[m] for m in members]
        return g

    @property
    def mesh(self) -> Optional["RankMesh"]:
        """The mesh of a sub-group (None for a group of its own)."""
        return None if self._mesh is None else self._mesh()

    # ---- running the ranks -----------------------------------------------
    def _groups(self) -> List["RankGroup"]:
        return [self]

    def _enter(self, r: int) -> None:
        _LOCAL.group, _LOCAL.rank = self, r

    def _done(self, r: int) -> None:
        self._where[r] = "done"

    def stream(self, rank: int):
        return self._streams[rank]

    def comm_stream(self, rank: int):
        return self._comm[rank]

    def rank(self) -> int:
        """This thread's rank in the group (a mesh sub-group answers from
        the thread's mesh coordinates)."""
        if self.mesh is None:
            if current_group() is not self:
                raise RankGroupError("this thread is not a rank of this "
                                     "group")
            return _LOCAL.rank
        if getattr(_LOCAL, "mesh", None) is self.mesh:
            r = self._index.get(_LOCAL.mesh_rank)
            if r is not None:
                return r
        raise RankGroupError("this thread is not a rank of this group")

    def spmd(self, fn: Callable, per_rank_args: Sequence[Sequence[Any]]
             ) -> List[Any]:
        if self.mesh is not None:
            raise RankGroupError("a mesh sub-group runs inside its mesh's "
                                 "spmd")
        return super().spmd(fn, per_rank_args)

    spmd.__doc__ = _Ranks.spmd.__doc__

    # ---- synchronisation --------------------------------------------------
    def barrier(self, what: str) -> None:
        """All ranks meet here; bounded by ``timeout_s``."""
        r = self.rank()
        self._where[r] = what
        try:
            self._barrier.wait(self.timeout_s)
        except threading.BrokenBarrierError:
            missing = {q: w for q, w in enumerate(self._where) if w != what}
            raise _BrokenBarrier(
                f"rank {r}: barrier of {what!r} broken or timed out after "
                f"{self.timeout_s} s; ranks elsewhere: {missing}") from None
        finally:
            self._where[r] = "running"

    def publish(self, x: Any, what: str
                ) -> List[Tuple[Any, Optional[torch.cuda.Event]]]:
        """Every rank posts ``x`` (and, on CUDA, an event recorded on its
        current stream after everything it queued so far, the work that
        produced ``x`` included); returns all ranks' pairs in rank order.
        ``x`` may be None: the events alone order the ranks' streams.  The
        slots
        alternate between two generations, so one barrier per exchange is
        enough: a rank can write generation g + 2 only after every rank
        passed the barrier of g + 1, that is after it read g."""
        r = self.rank()
        g = self._gen[r] & 1
        self._gen[r] += 1
        ev = (torch.cuda.current_stream(self.device).record_event()
              if self.cuda else None)
        self._slots[g][r] = (x, ev)
        self.barrier(what)
        return list(self._slots[g])

    def wait_for(self, pair, stream=None) -> torch.Tensor:
        """A peer's published tensor (or tuple of tensors), made safe to
        read on ``stream`` (default: the current one): the stream waits on
        the peer's event and each tensor is kept alive until the stream is
        done with it."""
        t, ev = pair
        if ev is not None:
            stream = stream or torch.cuda.current_stream(self.device)
            stream.wait_event(ev)
            for u in (t if isinstance(t, tuple) else (t,)):
                if isinstance(u, torch.Tensor) and u.is_cuda:
                    u.record_stream(stream)
        return t

    def stream_barrier(self, what: str) -> None:
        """This rank's stream waits until every rank's stream has done what
        it queued before this call (a host barrier plus events)."""
        for pair in self.publish(None, what):
            self.wait_for(pair)

    def exchange(self, x: torch.Tensor, what: str) -> List[torch.Tensor]:
        """All ranks' ``x`` in rank order, readable on this rank's stream."""
        return [self.wait_for(p) for p in self.publish(x, what)]

    def all_gather(self, x: torch.Tensor, dim: int, what: str
                   ) -> torch.Tensor:
        """Concatenate all ranks' ``x`` along ``dim``, in rank order."""
        return torch.cat(self.exchange(x, what), dim=dim)

    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]],
                 what: str) -> torch.Tensor:
        """Send ``x`` along ``perm`` ((src, dst) pairs, a permutation):
        returns a copy of what this rank's source sent, pulled onto this
        rank's stream once the source's event has fired.  ``x`` may be a
        tuple of tensors (a quantized payload and its scales): they move
        in the one exchange, and a tuple of copies comes back."""
        r = self.rank()
        srcs = [s for s, d in perm if d == r]
        if len(srcs) != 1:
            raise ValueError(f"perm {perm} sends {len(srcs)} tensors to "
                             f"rank {r}")
        pairs = self.publish(x, what)
        return clone(self.wait_for(pairs[srcs[0]]))

    # ---- shared buffers ---------------------------------------------------
    def symmetric(self, name: str, shape: Sequence[int], dtype: torch.dtype,
                  zero: bool = False) -> List[torch.Tensor]:
        """One buffer per rank for (name, shape, dtype), allocated at first
        use and kept; every rank sees all of them.  ``zero`` fills them with
        zeros when they are made (flag arrays)."""
        key = (name, tuple(shape), dtype)
        with self._lock:
            bufs = self._sym.get(key)
            if bufs is None:
                make = torch.zeros if zero else torch.empty
                bufs = [make(tuple(shape), dtype=dtype, device=self.device)
                        for _ in range(self.n)]
                if self.cuda:   # made on this thread's stream: wait for it
                    torch.cuda.current_stream(self.device).synchronize()
                self._sym[key] = bufs
        return bufs

    def free_symmetric(self) -> None:
        """Drop every cached buffer (call between ``spmd`` runs only)."""
        with self._lock:
            self._sym.clear()

    def next_epoch(self) -> int:
        """This rank's next flag value, in [1, EPOCHS]."""
        r = self.rank()
        self._epoch[r] += 1
        return self._epoch[r] % EPOCHS + 1


class _BrokenBarrier(RankGroupError):
    """A barrier that timed out or that another rank's failure aborted."""


class RankMesh(_Ranks):
    """``shape`` ranks over named ``axes`` on one device, numbered
    row-major (the last axis fastest), one thread and (on CUDA) two
    streams each (module docstring).  ``group(axis)`` is the calling
    rank's sub-group along ``axis``; ``coord(axis)`` its coordinate."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device=None, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.shape = tuple(int(s) for s in shape)
        self.axes = tuple(axes)
        if len(self.shape) != len(self.axes) or len(set(self.axes)) != len(
                self.axes) or min(self.shape, default=0) < 1:
            raise ValueError(f"a mesh needs one size >= 1 for each of its "
                             f"distinct axes: {self.shape} {self.axes}")
        self.size = self.n = math.prod(self.shape)
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self._timeout_s = timeout_s
        if self.cuda:
            self._streams = [torch.cuda.Stream(self.device)
                             for _ in range(self.size)]
            self._comm = [torch.cuda.Stream(self.device)
                          for _ in range(self.size)]
        self._coords = list(itertools.product(*(range(s)
                                                for s in self.shape)))
        self._rank_of = {c: r for r, c in enumerate(self._coords)}
        self._sub: Dict[Tuple[Any, int], RankGroup] = {}
        self._views: List[RankGroup] = []
        self._views_lock = threading.Lock()
        for axis in self.axes:
            self._make_views(axis)

    def _make_views(self, axis) -> None:
        """The views along ``axis`` (a name, or a tuple of names: the
        ranks that share every other coordinate, axis-major over the
        tuple)."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        dims = [self.axes.index(a) for a in names]
        for r, c in enumerate(self._coords):
            if (axis, r) in self._sub:
                continue
            members = []
            for idx in itertools.product(*(range(self.shape[d])
                                           for d in dims)):
                q = list(c)
                for d, i in zip(dims, idx):
                    q[d] = i
                members.append(self._rank_of[tuple(q)])
            view = RankGroup._view(self, members)
            self._views.append(view)
            for m in members:
                self._sub[(axis, m)] = view

    @property
    def timeout_s(self) -> float:
        return self._timeout_s

    @timeout_s.setter
    def timeout_s(self, value: float) -> None:
        """Every sub-group's barriers take the new bound."""
        self._timeout_s = value
        for g in self._views:
            g.timeout_s = value

    # ---- coordinates and sub-groups ---------------------------------------
    def rank(self) -> int:
        """The calling thread's mesh rank."""
        if getattr(_LOCAL, "mesh", None) is not self:
            raise RankGroupError("this thread is not a rank of this mesh")
        return _LOCAL.mesh_rank

    def coords(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        """A rank's coordinates (default: the calling rank's)."""
        return self._coords[self.rank() if rank is None else rank]

    def coord(self, axis: str, rank: Optional[int] = None) -> int:
        return self.coords(rank)[self.axes.index(axis)]

    def group(self, axis, rank: Optional[int] = None) -> RankGroup:
        """A rank's sub-group along ``axis`` (default: the calling
        rank's); a tuple of axes is the view over all of them, axis-major
        (built at its first use)."""
        if not isinstance(axis, str):
            axis = tuple(axis)
            if len(axis) == 1:
                axis = axis[0]
        names = (axis,) if isinstance(axis, str) else axis
        if not names or any(a not in self.axes for a in names) or len(
                set(names)) != len(names):
            raise ValueError(f"no axis {axis!r} in the mesh's {self.axes}")
        r = self.rank() if rank is None else rank
        if (axis, r) not in self._sub:
            with self._views_lock:
                self._make_views(axis)
        return self._sub[(axis, r)]

    # ---- running the ranks -----------------------------------------------
    def _groups(self) -> List[RankGroup]:
        return list(self._views)

    def _done(self, r: int) -> None:
        for view in list(self._views):
            if r in view._index:
                view._where[view._index[r]] = "done"

    def _enter(self, r: int) -> None:
        _LOCAL.mesh, _LOCAL.mesh_rank = self, r
        model = (self._sub[("model", r)] if "model" in self.axes else None)
        _LOCAL.group = model
        _LOCAL.rank = None if model is None else model._index[r]

    def free_symmetric(self) -> None:
        """Drop every sub-group's cached buffers (between ``spmd`` runs
        only)."""
        for g in self._views:
            g.free_symmetric()

