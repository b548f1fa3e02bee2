"""Explicit communication verbs — the Pstream facade.

Rebuild of reference: src/OpenFOAM/db/IOstreams/Pstreams/ (UPstream:
reduce/gather/scatter; PstreamBuffers: neighbour exchange) and
src/Pstream/mpi/ (the MPI backend). The equivalents here are XLA
collectives over a jax.sharding.Mesh axis, used inside shard_map:

    reduce(x, sumOp)        -> psum        (NCCL allreduce)
    reduce(x, maxOp/minOp)  -> pmax/pmin
    gatherList/scatter      -> all_gather
    processor-patch halo    -> ppermute neighbour exchange

Two usage modes exist in this framework:

1. IMPLICIT (default): the solvers run on global arrays sharded with
   NamedSharding (parallel/gspmd.py); XLA GSPMD inserts the
   collectives automatically. This is the production path.
2. EXPLICIT (this module): shard_map kernels with hand-placed
   collectives for the cases where GSPMD's choices need overriding —
   the halo-exchange SpMV below is the canonical pattern (the
   reference's processorFvPatchField::updateInterfaceMatrix twin).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


# ---------------------------------------------------------------------------
# Reduction / gather verbs (UPstream equivalents)
# ---------------------------------------------------------------------------


def reduce_sum(x: Any, axis: str = "space") -> Any:
    """gSum inside a shard_map region (reference: Foam::reduce(x,
    sumOp) -> MPI_Allreduce)."""
    return lax.psum(x, axis)


def reduce_max(x: Any, axis: str = "space") -> Any:
    return lax.pmax(x, axis)


def reduce_min(x: Any, axis: str = "space") -> Any:
    return lax.pmin(x, axis)


def gather_all(x: Any, axis: str = "space") -> Any:
    """gatherList+scatterList fused (reference: Pstream::gatherList) —
    every rank gets the concatenation."""
    return lax.all_gather(x, axis, tiled=True)


def my_rank(axis: str = "space") -> Any:
    """UPstream::myProcNo inside a shard_map region."""
    return lax.axis_index(axis)


# ---------------------------------------------------------------------------
# Halo-exchange SpMV (processor-interface update, explicit form)
# ---------------------------------------------------------------------------


def _neighbour_perms(n: int) -> Tuple[list, list]:
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd


def halo_spmv(jmesh: Mesh, deltas: Sequence[int], diag: Any, soff: Any,
              psi: Any, axis: str = "space") -> Any:
    """A @ psi with EXPLICIT one-ring halo exchange over a 1-D block
    partition of the cell dimension (reference:
    lduMatrix::Amul + initMatrixInterfaces/updateMatrixInterfaces via
    processorLduInterfaceField send/recv).

    Requirements: cells renumbered so every stencil offset |d| <= the
    shard block size (parallel/partition.py's contiguous-block
    renumbering guarantees this for structured meshes), and the matrix
    in slot form (soff [nC,M] aligned with `deltas`). Each shard
    ppermutes its first/last H rows to its neighbours — the exact
    analogue of the reference's per-processor-patch face exchange, with
    the wrap-around pair giving cyclic closure for periodic meshes.
    """
    n_dev = jmesh.devices.size
    H = max(max(abs(int(d)) for d in deltas), 1)
    fwd, bwd = _neighbour_perms(n_dev)

    def kernel(diag_l, soff_l, psi_l):
        b = psi_l.shape[0]
        if H > b:
            raise ValueError(f"halo width {H} exceeds shard block {b}")
        # send my TOP rows forward (they are the next shard's left halo)
        left = lax.ppermute(psi_l[-H:], axis, perm=fwd)
        right = lax.ppermute(psi_l[:H], axis, perm=bwd)
        ext = jnp.concatenate([left, psi_l, right], axis=0)  # [b+2H]
        acc = diag_l * psi_l
        for m, d in enumerate(deltas):
            seg = lax.dynamic_slice_in_dim(ext, H + int(d), b)
            acc = acc + soff_l[:, m] * seg
        return acc

    fn = jax.shard_map(
        kernel, mesh=jmesh,
        in_specs=(P(axis), P(axis, None), P(axis)),
        out_specs=P(axis),
    )
    return fn(diag, soff, psi)


def halo_apply_off(jmesh: Mesh, deltas: Sequence[int], soff: Any,
                   psi: Any, axis: str = "space") -> Any:
    """Off-diagonal SpMV (no diagonal term) with the explicit one-ring
    halo — the drop-in replacement for StencilOp.apply_off inside the
    Krylov solvers when FOAMTPU_HALO=explicit (parallel/gspmd.py
    activates it at shard_case time). Same block-partition requirements
    as halo_spmv; psi may be [nC] or multi-RHS [nC,C]."""
    n_dev = jmesh.devices.size
    H = max(max(abs(int(d)) for d in deltas), 1)
    fwd, bwd = _neighbour_perms(n_dev)
    vec = psi.ndim == 2

    def kernel(soff_l, psi_l):
        b = psi_l.shape[0]
        left = lax.ppermute(psi_l[-H:], axis, perm=fwd)
        right = lax.ppermute(psi_l[:H], axis, perm=bwd)
        ext = jnp.concatenate([left, psi_l, right], axis=0)
        acc = jnp.zeros_like(psi_l)
        for m, d in enumerate(deltas):
            seg = lax.dynamic_slice_in_dim(ext, H + int(d), b, axis=0)
            c = soff_l[:, m]
            acc = acc + (c[:, None] if vec else c) * seg
        return acc

    spec_psi = P(axis, None) if vec else P(axis)
    fn = jax.shard_map(
        kernel, mesh=jmesh,
        in_specs=(P(axis, None), spec_psi),
        out_specs=spec_psi,
    )
    return fn(soff, psi)


def halo_exchange(jmesh: Mesh, x: Any, width: int,
                  axis: str = "space") -> Tuple[Any, Any]:
    """Raw one-ring halo pull: returns (left_halo, right_halo) for each
    shard — the previous shard's last `width` rows and the next shard's
    first `width` rows (reference: PstreamBuffers fill/finishedSends/
    recv cycle for processor patches)."""
    n_dev = jmesh.devices.size
    fwd, bwd = _neighbour_perms(n_dev)

    def kernel(x_l):
        left = lax.ppermute(x_l[-width:], axis, perm=fwd)
        right = lax.ppermute(x_l[:width], axis, perm=bwd)
        return left, right

    fn = jax.shard_map(kernel, mesh=jmesh, in_specs=P(axis),
                       out_specs=(P(axis), P(axis)))
    return fn(x)


def sharded_dot(jmesh: Mesh, a: Any, b: Any, axis: str = "space") -> Any:
    """Global dot product with an explicit psum (the per-CG-iteration
    gSumProd of the reference, PCG.C)."""

    def kernel(a_l, b_l):
        return lax.psum(jnp.vdot(a_l, b_l), axis)

    fn = jax.shard_map(kernel, mesh=jmesh, in_specs=(P(axis), P(axis)),
                       out_specs=P())
    return fn(a, b)
