"""Deterministic, seekable synthetic token pipeline (a copy of the
reference's ``data/pipeline.py``: numpy only, so the same seed gives the
same tokens on both sides).

Production shape: each HOST generates only its data shard (host-sharded
loading); the stream is a pure function of (seed, step, shard) so restart
from a checkpoint reproduces the exact batch sequence (fault tolerance
requires a seekable data source — no iterator state in checkpoints, just
the step counter).

The generator is a cheap stateless hash (a numpy philox-style mix, on the
host) producing Zipf-ish token frequencies so MoE routing and vocab losses
see a realistic skew.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


_U64 = np.uint64


def _mix(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> 33)) * np.uint64(0xFF51AFD7ED558CCD)
    x = (x ^ (x >> 33)) * np.uint64(0xC4CEB9FE1A85EC53)
    return x ^ (x >> 33)


def batch_at(cfg: DataConfig, step: int, shard: int = 0,
             num_shards: int = 1) -> Dict[str, np.ndarray]:
    """The (step, shard) batch — pure function, O(1) seek."""
    if cfg.global_batch % num_shards:
        raise ValueError(f"global_batch {cfg.global_batch} is not divisible "
                         f"by {num_shards} shards")
    b_loc = cfg.global_batch // num_shards
    with np.errstate(over="ignore"):   # wrapping uint64 mixes are intended
        idx = (_U64(cfg.seed) * _U64(0x9E3779B97F4A7C15)
               + _U64(step) * _U64(cfg.global_batch * (cfg.seq_len + 1))
               + (np.arange(b_loc * (cfg.seq_len + 1), dtype=np.uint64)
                  + _U64(shard * b_loc * (cfg.seq_len + 1))))
    u = _mix(idx).astype(np.float64) / float(2 ** 64)
    # inverse-CDF Zipf-ish sampling onto [0, vocab)
    ranks = np.power(u + 1e-12, cfg.zipf_a * 1.8)
    toks = np.minimum((ranks * cfg.vocab_size).astype(np.int64),
                      cfg.vocab_size - 1)
    toks = toks.reshape(b_loc, cfg.seq_len + 1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class DataStream:
    """Stateful convenience wrapper (state == step, nothing else)."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1,
                 start_step: int = 0):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = batch_at(self.cfg, self.step, self.shard, self.num_shards)
        self.step += 1
        return b

    def seek(self, step: int) -> None:
        self.step = step
