"""Rank meshes (port of ``repro.launch.mesh``).

``make_mesh(pods, dp, tp, device)`` is the reference's mesh with its axis
order and names: ``("pod", "data", "model")`` when ``pods > 1``, else
``("data", "model")``, so model code can always address "data" and
"model".  The port's mesh is a ``dist.RankMesh``: every rank a thread on
the one device.  ``dp_axes`` names the axes that carry the batch and
the grad sync, pod before data.  ``elastic_remesh`` rebuilds a mesh from
the surviving ranks: TP groups stay whole (a TP group dies with any of
its members) and dp shrinks to what still forms full groups.  The
reference's dedicated ``ep`` axis is not ported (ROADMAP queue 1 item
10).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.dist import RankMesh

DP_AXES = ("pod", "data")


def make_mesh(pods: int, dp: int, tp: int, device=None) -> RankMesh:
    """The (pods, dp, tp) mesh, "pod" dropped when ``pods == 1``."""
    if pods > 1:
        return RankMesh((pods, dp, tp), ("pod", "data", "model"), device)
    return RankMesh((dp, tp), ("data", "model"), device)


def dp_axes(mesh: RankMesh) -> Tuple[str, ...]:
    """The axes that carry data parallelism (batch), pod before data."""
    return tuple(a for a in DP_AXES if a in mesh.axes)


def elastic_remesh(surviving_ranks: int, tp: int, device=None) -> RankMesh:
    """A ("data", "model") mesh after failures: TP whole, dp shrunk to the
    full TP groups the survivors still form."""
    usable = (surviving_ranks // tp) * tp
    if usable == 0:
        raise RuntimeError(f"cannot form a single {tp}-way TP group from "
                           f"{surviving_ranks} ranks")
    return RankMesh((usable // tp, tp), ("data", "model"), device)
