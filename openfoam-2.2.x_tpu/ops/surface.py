"""Gather-based surface primitives — the hot-path substrate.

Everything in the FV method reduces to two motions:
  (1) cell -> face: interpolate cell values to faces (gather owner +
      neighbour values, blend);
  (2) face -> cell: sum signed face values into cells
      (reference: fvc::surfaceIntegrate,
      src/finiteVolume/finiteVolume/fvc/fvcSurfaceIntegrate.C).

The reference does (2) with a sequential scatter over owner/neighbour.
Here we instead gather via the precomputed per-cell face tables
(mesh.cface [nC,K]) and reduce over the small K axis — dense, fusible,
no scatters. XLA fuses the gather + multiply + reduce into one pass.
"""

from __future__ import annotations

from typing import Any, Optional

import jax.numpy as jnp


def gather_faces(mesh, face_vals: Any) -> Any:
    """[nF,(3)] face array -> [nC,K,(3)] per-cell gathered values."""
    return face_vals[mesh.cface]


def scatter_set_cols(acc: Any, idx: Any, vals: Any) -> Any:
    """acc[idx] = vals, one component column at a time: a 1-D scatter
    has no layout to constrain, so a vector accumulator keeps whichever
    layout XLA prefers for it."""
    if acc.ndim == 1:
        return acc.at[idx].set(vals)
    a2 = acc.reshape(acc.shape[0], -1)
    v2 = vals.reshape(vals.shape[0], -1)
    cols = [a2[:, j].at[idx].set(v2[:, j]) for j in range(a2.shape[1])]
    return jnp.stack(cols, axis=1).reshape(acc.shape)


def surface_sum(mesh, face_vals: Any, weight: Optional[Any] = None) -> Any:
    """sum_f sign_f * face_vals_f per cell. weight overrides the signed
    mask (e.g. mesh.cbnd to sum boundary-face contributions only)."""
    w = mesh.csign if weight is None else weight
    g = face_vals[mesh.cface]
    if g.ndim == 3:  # vector face values
        return jnp.sum(g * w[:, :, None], axis=1)
    return jnp.sum(g * w, axis=1)


def boundary_sum(mesh, bvals: Any) -> Any:
    """Sum per-boundary-face values [nBf,(3)] into their owner cells.
    Compact scatter over ACTIVE boundary faces only (mesh.ab_rel):
    empty-patch faces — 2*nC of them on a 2D case — always carry zero
    (face_active-masked upstream), so scattering them is wasted work."""
    shape = (mesh.n_cells,) if bvals.ndim == 1 else (mesh.n_cells, bvals.shape[1])
    out = jnp.zeros(shape, dtype=bvals.dtype)
    return out.at[mesh.ab_owner].add(bvals[mesh.ab_rel])


def owner_to_b(mesh, x: Any) -> Any:
    """Owner-cell values extrapolated to the boundary, [nBf(,C)]:
    active faces get x[owner]; empty-patch faces get zero (they are
    face_active-masked by every consumer). The compact twin of
    x[mesh.owner[nif:]]: it touches active boundary faces only."""
    nBf = mesh.n_faces - mesh.n_internal_faces
    z = jnp.zeros((nBf,) + x.shape[1:], x.dtype)
    return scatter_set_cols(z, mesh.ab_rel, x[mesh.ab_owner])


def interpolate_internal(mesh, data: Any, weights: Optional[Any] = None) -> Any:
    """Cell data -> internal-face values with owner-side weights w:
    vf = w*v_own + (1-w)*v_nei. Default: linear (central) weights."""
    nif = mesh.n_internal_faces
    w = mesh.weights[:nif] if weights is None else weights
    vo = data[mesh.owner[:nif]]
    vn = data[mesh.neighbour]
    w = w.reshape((-1,) + (1,) * (data.ndim - 1))
    return w * vo + (1.0 - w) * vn


def face_values(mesh, field, weights: Optional[Any] = None) -> Any:
    """Full-face interpolated values [nF,(3)]: internal faces blended,
    boundary faces from BC evaluation."""
    vi = interpolate_internal(mesh, field.data, weights)
    vb = field.boundary_values(mesh)
    return jnp.concatenate([vi, vb], axis=0)


def delta(mesh, data: Any) -> Any:
    """Owner->neighbour difference on internal faces: v_nei - v_own."""
    nif = mesh.n_internal_faces
    d = data[mesh.neighbour] - data[mesh.owner[:nif]]
    return d
