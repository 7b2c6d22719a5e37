"""Rank meshes (port of ``repro.launch.mesh``).

``make_mesh(pods, dp, tp, device, ep=1)`` is the reference's mesh with its
axis order and names: ``("pod", "ep", "data", "model")``, "pod" dropped
when ``pods == 1`` and the dedicated expert-parallel axis "ep" when
``ep == 1``, so model code can always address "data" and "model".  The
port's mesh is a ``dist.RankMesh``: every rank a thread on the one
device.  ``dp_axes`` names the axes that carry the batch, pod, then ep,
then data: a dedicated "ep" axis shards the batch too, and only the MoE
layers' ``moe_a2a`` seam crosses it.  ``elastic_remesh`` rebuilds a mesh
from the surviving ranks: TP groups stay whole (a TP group dies with any
of its members) and dp shrinks to what still forms full groups.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.dist import RankMesh

DP_AXES = ("pod", "ep", "data")


def make_mesh(pods: int, dp: int, tp: int, device=None, ep: int = 1
              ) -> RankMesh:
    """The (pods, ep, dp, tp) mesh, "pod" dropped when ``pods == 1`` and
    "ep" when ``ep == 1``."""
    shape, axes = [], []
    for size, axis in ((pods, "pod"), (ep, "ep")):
        if size > 1:
            shape.append(size)
            axes.append(axis)
    return RankMesh((*shape, dp, tp), (*axes, "data", "model"), device)


def mesh_shape(par) -> Tuple[int, ...]:
    """The shape ``make_mesh`` gives a ``ParallelConfig``."""
    return tuple(s for s, keep in ((par.pods, par.pods > 1),
                                   (par.ep, par.ep > 1), (par.dp, True),
                                   (par.tp, True)) if keep)


def dp_axes(mesh: RankMesh) -> Tuple[str, ...]:
    """The axes that carry data parallelism (batch): pod, ep, data."""
    return tuple(a for a in DP_AXES if a in mesh.axes)


def mesh_coords(mesh: Optional[RankMesh], r: int) -> Dict[str, int]:
    """Mesh rank r's index on each mesh axis (0 on an absent one): the
    ``coords`` of ``models.model.mesh_shard``."""
    return {a: mesh.coord(a, r) if mesh is not None and a in mesh.axes
            else 0 for a in ("pod", "ep", "data", "model")}


def elastic_remesh(surviving_ranks: int, tp: int, device=None) -> RankMesh:
    """A ("data", "model") mesh after failures: TP whole, dp shrunk to the
    full TP groups the survivors still form."""
    usable = (surviving_ranks // tp) * tp
    if usable == 0:
        raise RuntimeError(f"cannot form a single {tp}-way TP group from "
                           f"{surviving_ranks} ranks")
    return RankMesh((usable // tp, tp), ("data", "model"), device)
