"""Dynamic mesh — device-side geometry recompute + solid-body motion.

Rebuild of reference: src/dynamicFvMesh/ (dynamicFvMesh,
solidBodyMotionFvMesh with src/fvMotionSolver solidBodyMotionFunctions
linearMotion / oscillatingLinearMotion / rotatingMotion) and the
mesh-flux (meshPhi) machinery of moving-mesh solvers
(pimpleDyMFoam).

Redesign: mesh TOPOLOGY is static (the jit program, slot tables
and stencil offsets never change); mesh GEOMETRY (points -> face
centres/areas -> cell centres/volumes -> interpolation factors ->
slot-geometry) is recomputed ON DEVICE each motion step by the same
algorithms the host uses at load (mesh/core.py:
face_centres_areas / cell_centres_volumes / _update_interpolation).
The per-motion-step gathers are fine — they run once per time step,
not once per solver iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .core import FvMesh, PolyMesh


class MeshTopo(NamedTuple):
    """Static-topology device tables needed to rebuild geometry from
    points."""
    face_pts: Any      # [nF,maxPts] int32 (pad clamped to 0)
    face_valid: Any    # [nF,maxPts] 1/0
    face_npts: Any     # [nF] float
    nxt: Any           # [nF,maxPts] int32: next-vertex slot index
    face_shift: Any    # [nIf,3] (zeros when no cyclics)
    wall_faces: Any    # [nWf] int32 flat wall-face ids
    wall_cells: Any    # [nWf] int32 owner cells of those faces


def topo_from_poly(pm: PolyMesh, dtype) -> MeshTopo:
    nF, mp = pm.face_pts.shape
    idx = np.arange(mp)
    valid = idx[None, :] < pm.face_npts[:, None]
    fpts = np.clip(pm.face_pts, 0, None)
    nxt = (idx[None, :] + 1) % np.maximum(pm.face_npts[:, None], 1)
    shift = (pm.face_shift if pm.face_shift is not None
             else np.zeros((pm.n_internal_faces, 3)))
    wf, wc = [], []
    for p in pm.patches:
        if p.type == "wall":
            f = np.arange(p.start, p.start + p.size)
            wf.append(f)
            wc.append(pm.owner[f])
    wall_faces = (np.concatenate(wf) if wf else np.zeros(0, np.int64))
    wall_cells = (np.concatenate(wc) if wc else np.zeros(0, np.int64))
    return MeshTopo(
        face_pts=jnp.asarray(fpts, jnp.int32),
        face_valid=jnp.asarray(valid.astype(np.float64), dtype),
        face_npts=jnp.asarray(pm.face_npts.astype(np.float64), dtype),
        nxt=jnp.asarray(nxt, jnp.int32),
        face_shift=jnp.asarray(shift, dtype),
        wall_faces=jnp.asarray(wall_faces, jnp.int32),
        wall_cells=jnp.asarray(wall_cells, jnp.int32))


def update_geometry(mesh: FvMesh, points: Any, topo: MeshTopo) -> FvMesh:
    """Recompute every geometric quantity of the FvMesh from new point
    positions (jit-able; topology static)."""
    nif = mesh.n_internal_faces
    nC = mesh.n_cells

    # -- face centres / areas (fan triangulation, mesh/core.py:74) ---------
    fp = points[topo.face_pts] * topo.face_valid[:, :, None]
    c_est = jnp.sum(fp, axis=1) / topo.face_npts[:, None]
    p_i = fp
    p_n = jnp.take_along_axis(fp, topo.nxt[:, :, None], axis=1)
    n_tri = jnp.cross(p_n - p_i, c_est[:, None, :] - p_i)
    n_tri = n_tri * topo.face_valid[:, :, None]
    a_tri = jnp.linalg.norm(n_tri, axis=2)
    c_tri = (p_i + p_n + c_est[:, None, :]) / 3.0
    sum_n = jnp.sum(n_tri, axis=1)
    sum_a = jnp.sum(a_tri, axis=1)
    sum_ac = jnp.sum(a_tri[:, :, None] * c_tri, axis=1)
    small = sum_a < 1e-20
    cf = jnp.where(small[:, None], c_est,
                   sum_ac / jnp.maximum(sum_a, 1e-30)[:, None])
    sf = 0.5 * sum_n
    mag_sf = jnp.linalg.norm(sf, axis=1)

    # -- cell centres / volumes (pyramids, mesh/core.py:107) ---------------
    cf_nei = cf[:nif] + topo.face_shift
    own, nei = mesh.owner, mesh.neighbour
    seg = jax.ops.segment_sum
    c_acc = (seg(cf, own, num_segments=nC)
             + seg(cf_nei, nei, num_segments=nC))
    n_cf = (seg(jnp.ones_like(mag_sf), own, num_segments=nC)
            + seg(jnp.ones(nif, mag_sf.dtype), nei, num_segments=nC))
    ce = c_acc / n_cf[:, None]

    def pyr(cells, sign, cf_, sf_):
        p3 = sign * jnp.einsum("fi,fi->f", sf_, cf_ - ce[cells])
        pc = 0.75 * cf_ + 0.25 * ce[cells]
        return (seg(p3, cells, num_segments=nC),
                seg(p3[:, None] * pc, cells, num_segments=nC))

    v1, c1 = pyr(own, 1.0, cf, sf)
    v2, c2 = pyr(nei, -1.0, cf_nei, sf[:nif])
    vol3 = v1 + v2
    ctr = jnp.where(jnp.abs(vol3)[:, None] > 1e-30,
                    (c1 + c2) / vol3[:, None], ce)
    v = vol3 / 3.0

    # -- interpolation factors (mesh/core.py:_update_interpolation) --------
    c_nei = ctr[nei] - topo.face_shift
    sfd_own = jnp.abs(jnp.einsum("fi,fi->f", sf[:nif],
                                 cf[:nif] - ctr[own[:nif]]))
    sfd_nei = jnp.abs(jnp.einsum("fi,fi->f", sf[:nif], c_nei - cf[:nif]))
    w = jnp.ones(mesh.n_faces, v.dtype)
    w = w.at[:nif].set(sfd_nei / jnp.maximum(sfd_own + sfd_nei, 1e-30))
    delta = jnp.concatenate(
        [c_nei - ctr[own[:nif]], cf[nif:] - ctr[own[nif:]]], axis=0)
    mag_delta = jnp.linalg.norm(delta, axis=1)
    dc = 1.0 / jnp.maximum(mag_delta, 1e-30)
    nhat = sf / jnp.maximum(mag_sf, 1e-30)[:, None]
    sn = jnp.einsum("fi,fi->f", nhat, delta)
    nodc = 1.0 / jnp.maximum(sn, 0.05 * mag_delta)
    corr = nhat - delta * nodc[:, None]

    # -- slot-form geometry re-gather (to_device block) --------------------
    st_cf = mesh.st_cface
    st_v = mesh.st_valid
    st_s = mesh.st_sign
    w_i = w[st_cf]
    st_wself = jnp.where(st_s > 0, w_i, 1.0 - w_i) * st_v
    st_magsf = mag_sf[st_cf] * st_v
    st_dc = dc[st_cf] * st_v
    st_nodc = nodc[st_cf] * st_v
    st_sf = sf[st_cf] * (st_v * st_s)[:, :, None]
    st_corr = corr[st_cf] * st_v[:, :, None]
    if mesh.fb_faces.shape[0]:
        fb_w = w[mesh.fb_faces]
        fb_wself = jnp.where(mesh.fb_signs > 0, fb_w, 1.0 - fb_w)
        fb_magsf = mag_sf[mesh.fb_faces]
        fb_dc = dc[mesh.fb_faces]
        fb_nodc = nodc[mesh.fb_faces]
        fb_sf = sf[mesh.fb_faces] * mesh.fb_signs[:, None]
        fb_corr = corr[mesh.fb_faces]
    else:
        fb_wself, fb_magsf, fb_dc, fb_nodc = (mesh.fb_wself,
                                              mesh.fb_magsf,
                                              mesh.fb_dc, mesh.fb_nodc)
        fb_sf, fb_corr = mesh.fb_sf, mesh.fb_corr

    # wall distance of wall-adjacent cells
    if topo.wall_faces.shape[0]:
        yw = 1.0 / jnp.maximum(dc[topo.wall_faces], 1e-30)
        acc = seg(yw, topo.wall_cells, num_segments=nC)
        wall_y = jnp.where(mesh.wall_cnt > 0,
                           acc / jnp.maximum(mesh.wall_cnt, 1.0), 1.0)
    else:
        wall_y = mesh.wall_y

    nif_ = mesh.n_internal_faces
    ab_sf = sf[nif_:][mesh.ab_rel]
    return dataclasses.replace(
        mesh, ab_sf=ab_sf,
        sf=sf, mag_sf=mag_sf, cf=cf, c=ctr, v=v, weights=w,
        delta_coeffs=dc, non_orth_delta_coeffs=nodc,
        correction_vecs=corr, st_wself=st_wself, st_magsf=st_magsf,
        st_dc=st_dc, st_nodc=st_nodc, st_sf=st_sf, st_corr=st_corr,
        fb_wself=fb_wself, fb_magsf=fb_magsf, fb_dc=fb_dc,
        fb_nodc=fb_nodc, fb_sf=fb_sf, fb_corr=fb_corr, wall_y=wall_y)


# ---------------------------------------------------------------------------
# solidBodyMotionFunctions (reference: src/fvMotionSolver/
# solidBodyMotionFunctions/{linearMotion,oscillatingLinearMotion,
# rotatingMotion})
# ---------------------------------------------------------------------------


def linear_motion(velocity) -> Tuple[Callable, Callable]:
    """points(t) = p0 + v t; U_mesh = v."""
    vv = np.asarray(velocity, dtype=float)

    def pts(p0, t):
        return p0 + jnp.asarray(vv, p0.dtype) * t

    def umesh(x, t):
        return jnp.broadcast_to(jnp.asarray(vv, x.dtype), x.shape)

    return pts, umesh


def oscillating_linear_motion(amplitude, omega: float
                              ) -> Tuple[Callable, Callable]:
    """points(t) = p0 + A sin(w t); U_mesh = A w cos(w t)."""
    A = np.asarray(amplitude, dtype=float)

    def pts(p0, t):
        return p0 + jnp.asarray(A, p0.dtype) * jnp.sin(omega * t)

    def umesh(x, t):
        return jnp.broadcast_to(
            jnp.asarray(A, x.dtype) * (omega * jnp.cos(omega * t)),
            x.shape)

    return pts, umesh


def rotating_motion(origin, axis, omega: float
                    ) -> Tuple[Callable, Callable]:
    """Rigid rotation about (origin, axis) at rate omega [rad/s]."""
    o = np.asarray(origin, dtype=float)
    ax = np.asarray(axis, dtype=float)
    ax = ax / max(np.linalg.norm(ax), 1e-30)

    def pts(p0, t):
        th = omega * t
        k = jnp.asarray(ax, p0.dtype)
        r = p0 - jnp.asarray(o, p0.dtype)
        # Rodrigues rotation
        return (jnp.asarray(o, p0.dtype) + r * jnp.cos(th)
                + jnp.cross(jnp.broadcast_to(k, r.shape), r)
                * jnp.sin(th)
                + k[None, :] * (r @ k)[:, None] * (1 - jnp.cos(th)))

    def umesh(x, t):
        k = jnp.asarray(ax, x.dtype)
        r = x - jnp.asarray(o, x.dtype)
        return omega * jnp.cross(jnp.broadcast_to(k, r.shape), r)

    return pts, umesh


def mesh_flux(mesh: FvMesh, umesh_fn: Callable, t) -> Any:
    """meshPhi: U_mesh . Sf at face centres (exact space-conservation
    flux for rigid motions — reference: fvMesh::phi())."""
    um = umesh_fn(mesh.cf, t)
    return jnp.einsum("fi,fi->f", um, mesh.sf)
