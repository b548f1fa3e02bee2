"""Multi-chip parallelism: GSPMD sharding of the global mesh/state.

The reference's ONLY parallel strategy is SPMD domain decomposition of
the mesh with halo exchange over MPI (reference: src/Pstream/mpi/,
decomposePar, processorFvPatchField — SURVEY.md §2b). The accelerator
equivalent implemented here:

- Cells (and faces) stay GLOBAL, padded arrays; a `jax.sharding.Mesh`
  with one "space" axis shards the cell/face dimensions across chips
  (NamedSharding). decomposePar becomes `partition.renumber_for` —
  a host-side reordering so each chip owns a contiguous, spatially
  compact cell block and cross-shard faces are few.
- XLA GSPMD inserts the collectives: the cell->cell gathers at shard
  boundaries become the halo exchange, reductions become psums over
  the interconnect. This is the "let the compiler insert collectives"
  recipe; the explicit shard_map + ppermute halo kernel is the planned
  next optimisation (per-shard local indices + ragged halo buckets).

Works identically on a multi-GPU host and on
XLA_FLAGS=--xla_force_host_platform_device_count=N CPU meshes (the
analogue of the reference's mpirun-on-one-box testing).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def space_mesh(n_devices: int | None = None, axis: str = "space") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _shard_leaf(x, jmesh: Mesh, n_cells: int, n_faces: int, axis: str):
    """Shard any leaf whose leading dim is the cell or face dimension."""
    if not hasattr(x, "shape") or x.ndim == 0:
        return x
    lead = x.shape[0]
    if lead in (n_cells, n_faces) and lead % jmesh.devices.size == 0:
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(jmesh, spec))
    return jax.device_put(x, NamedSharding(jmesh, P(*([None] * x.ndim))))


def shard_pytree(tree: Any, jmesh: Mesh, n_cells: int, n_faces: int,
                 axis: str = "space") -> Any:
    return jax.tree_util.tree_map(
        lambda x: _shard_leaf(x, jmesh, n_cells, n_faces, axis), tree
    )


_HALO_JMESH: Mesh | None = None
_HALO_AXIS: str = "space"


def active_halo_mesh():
    """(jmesh, axis) when FOAMTPU_HALO=explicit was active at
    shard_case time, else (None, axis) — consulted at TRACE time by
    the Krylov solvers to swap the fine-level SpMV for the explicit
    ppermute halo kernel (parallel/comm.py::halo_apply_off;
    reference seam: processorFvPatchField::updateInterfaceMatrix)."""
    return _HALO_JMESH, _HALO_AXIS


def arm_halo(jmesh: Mesh, axis: str = "space") -> None:
    """Arm the explicit halo-exchange SpMV for later solver traces when
    FOAMTPU_HALO=explicit (shard_case and `run -parallel`)."""
    import os as _os

    global _HALO_JMESH, _HALO_AXIS
    if _os.environ.get("FOAMTPU_HALO", "") == "explicit":
        _HALO_JMESH, _HALO_AXIS = jmesh, axis


def shard_case(mesh, state: Dict, jmesh: Mesh, axis: str = "space"):
    """Place an FvMesh + solver state over the device mesh.

    FOAMTPU_HALO=explicit additionally arms the explicit halo-exchange
    SpMV for subsequent solver traces (the latency-optimal path on a real
    multi-GPU interconnect; equal results to GSPMD by construction,
    asserted in tests/test_halo_production.py)."""
    arm_halo(jmesh, axis)
    nc, nf = mesh.n_cells, mesh.n_faces
    return (
        shard_pytree(mesh, jmesh, nc, nf, axis),
        shard_pytree(state, jmesh, nc, nf, axis),
    )
