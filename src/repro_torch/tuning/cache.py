"""Persistent JSON profile cache for tuned seam plans (port of
``repro.tuning.cache``).

One profile file holds the tuned plans of one (model, mesh, backend), e.g.
``experiments/plans_torch/minicpm_2b_tp4.json``.  The schema is the
reference's (``PROFILE_VERSION`` is the same number because the schema is
the same); the port's ``backend`` is "cuda" or "cpu", the device the
plans were tuned on.  Loading applies the reference's staleness rules: a
file whose ``version``, ``mesh.n_dev`` or ``backend`` disagrees with the
requester's loads as an empty registry, so a profile tuned on a TPU or
on the CPU never loads on the card.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional

from repro_torch.tuning.plans import SeamPlan, seam_of

PROFILE_VERSION = 2


def default_backend() -> str:
    """"cuda" when a card is visible, else "cpu" (``jax.default_backend``'s
    counterpart); callers that know the device they run on pass it."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def default_plans_dir() -> str:
    """``experiments/plans_torch/`` at the repo root (git-ignored: runs on
    the card leave the tree clean; the reference's profiles stay in
    ``experiments/plans/``)."""
    return os.path.normpath(os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "experiments",
        "plans_torch"))


def entry_key(seam: str, m: int, n: int, k: int, n_dev: int,
              dtype_bytes: int = 2) -> str:
    return f"{seam}|m{m},n{n},k{k},tp{n_dev},b{dtype_bytes}"


@dataclasses.dataclass
class PlanRegistry:
    """In-memory view of one profile file: ``entries`` maps
    :func:`entry_key` strings to the seam's metadata and its serialized
    plan."""
    n_dev: int
    backend: str = ""
    entries: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    path: Optional[str] = None

    def __post_init__(self):
        if not self.backend:
            self.backend = default_backend()

    def record(self, seam: str, kind: str, m: int, n: int, k: int,
               plan: SeamPlan, dtype_bytes: int = 2) -> None:
        self.entries[entry_key(seam, m, n, k, self.n_dev, dtype_bytes)] = {
            "seam": seam, "kind": kind, "m": m, "n": n, "k": k,
            "n_dev": self.n_dev, "dtype_bytes": dtype_bytes,
            "plan": plan.to_json()}

    def stamp_scatter_axis(self, scatter_axis: str) -> None:
        """Rewrite every entry's plan to one activation layout (a profile
        mixing layouts would make ``PlanSet.residual_layout()`` raise at
        load)."""
        for e in self.entries.values():
            e["plan"] = dict(e["plan"], scatter_axis=scatter_axis)

    def lookup(self, seam: str, m: int, n: int, k: int,
               dtype_bytes: int = 2) -> Optional[SeamPlan]:
        e = self.entries.get(entry_key(seam, m, n, k, self.n_dev, dtype_bytes))
        return SeamPlan.from_json(e["plan"]) if e else None

    def seam_plans(self) -> Dict[str, SeamPlan]:
        """Best-known plan per model seam name (last wins), whatever the
        shapes: one profile serves every batch.  A cell-qualified entry
        (``"attn_ag@kv_up"``) stays under its own key and also answers for
        the bare seam name through the largest-FLOPs cell's plan, unless
        an exact bare entry exists."""
        out: Dict[str, SeamPlan] = {}
        alias: Dict[str, tuple] = {}        # base seam -> (flops, plan)
        for e in self.entries.values():
            key = e["seam"]
            plan = SeamPlan.from_json(e["plan"])
            out[key] = plan
            base = seam_of(key)
            if base != key:
                fl = 2 * e["m"] * e["n"] * e["k"]
                if base not in alias or fl > alias[base][0]:
                    alias[base] = (fl, plan)
        for base, (_, plan) in alias.items():
            if base not in out:
                out[base] = plan
        return out

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("PlanRegistry.save needs a path")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        doc = {"version": PROFILE_VERSION, "backend": self.backend,
               "mesh": {"n_dev": self.n_dev}, "entries": self.entries}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        self.path = path
        return path

    @classmethod
    def open(cls, path: str, *, n_dev: int,
             backend: Optional[str] = None) -> "PlanRegistry":
        """Load a profile; an empty registry when the file is missing,
        unreadable or stale (version / mesh / backend mismatch)."""
        reg = cls(n_dev=n_dev, backend=backend or default_backend(),
                  path=path)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return reg
        if not isinstance(doc, Mapping):
            return reg
        if doc.get("version") != PROFILE_VERSION:
            return reg
        if doc.get("mesh", {}).get("n_dev") != n_dev:
            return reg
        if doc.get("backend") != reg.backend:
            return reg
        entries = doc.get("entries", {})
        if isinstance(entries, Mapping):
            reg.entries = dict(entries)
        return reg
