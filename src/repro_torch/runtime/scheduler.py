"""Continuous-batching chunk scheduler: prefill chunks interleaved with decode.

Bounds head-of-line TTFT: a long prompt never monopolizes the server while
it prefills.  ``Server.begin_admission`` only RESERVES a slot + KV blocks
(O(1), no dispatch); the scheduler then runs AT MOST ONE fixed-size prefill
chunk per tick — round-robin across in-flight admissions — followed by one
decode step for every already-generating slot.  Decode therefore stalls for
at most one chunk's latency per tick regardless of prompt length, and
concurrent long prompts share the prefill lane fairly.

Timing is stamped here and in the server (the server OWNS request timing):
``t_arrival`` on submit (unless the traffic generator pre-stamped a
scheduled arrival — open-loop TTFT then includes queueing delay),
``t_first_token`` when the final prefill chunk emits token 0, ``t_finish``
on completion.
"""
from __future__ import annotations

import time
from collections import deque
from typing import TYPE_CHECKING, Deque, List

if TYPE_CHECKING:                      # avoid a runtime import cycle
    from repro_torch.runtime.server import PrefillJob, Request, Server


class ChunkScheduler:
    def __init__(self, server: "Server"):
        self.srv = server
        self.pending: "Deque[Request]" = deque()   # FIFO admission queue
        self.jobs: "Deque[PrefillJob]" = deque()   # in-flight chunked prefills

    def submit(self, req: "Request") -> None:
        if req.t_arrival is None:
            req.t_arrival = time.perf_counter()
        self.pending.append(req)

    def has_work(self) -> bool:
        return bool(self.pending or self.jobs
                    or any(s is not None for s in self.srv.slots))

    def tick(self) -> List["Request"]:
        """One scheduling round.  Returns the requests that finished (or
        were rejected) during this tick."""
        srv = self.srv
        out: List["Request"] = []

        # 1) admissions: reserve slots + blocks for whatever fits (FIFO —
        #    a stuck head request must not be overtaken forever)
        while self.pending:
            try:
                job = srv.begin_admission(self.pending[0])
            except ValueError as e:
                req = self.pending.popleft()
                req.done = True
                req.error = str(e)
                req.t_finish = time.perf_counter()
                out.append(req)
                continue
            if job is None:
                break
            self.pending.popleft()
            self.jobs.append(job)

        # 2) ONE prefill chunk this tick (round-robin over admissions)
        if self.jobs:
            job = self.jobs.popleft()
            if srv.prefill_chunk(job):
                if job.req.done:       # finished at admission (EOS / max=1)
                    out.append(job.req)
            else:
                self.jobs.append(job)

        # 3) one decode step for every generating slot
        out.extend(srv.step())

        # Deadlock guard: nothing progressed, nothing is in flight, and
        # every slot is free — the head request needs more KV blocks than
        # the pool can EVER free.  Reject it so the queue keeps moving.
        if (not out and self.pending and not self.jobs
                and not any(s is not None for s in srv.slots)):
            req = self.pending.popleft()
            req.done = True
            req.error = (f"pool exhausted: rid {req.rid} needs "
                         f"{srv._blocks_needed(len(req.prompt))} KV blocks, "
                         f"pool holds {srv.pool.num_blocks - 1}")
            req.t_finish = time.perf_counter()
            out.append(req)
        return out
