"""lagrangian — particle cloud tracking and kinematic parcels.

Rebuild of reference: src/lagrangian/{basic,intermediate}/ (Cloud,
particle::trackToFace, KinematicParcel with sphereDrag + gravity) and
applications/solvers/lagrangian/icoUncoupledKinematicParcelFoam/.

Redesign — the reference tracks each particle with a sequential
face-to-face walk (particle.C: trackToFace loop); here the SAME
geometric walk runs data-parallel over the whole cloud:

- The cloud is a fixed-size struct-of-arrays pytree ([Np] slots with an
  `active` mask — dead/unused slots keep shapes static for jit).
- One transport step = a bounded `lax.fori_loop` of face-hop rounds.
  Each round, EVERY active particle computes its exit face in its
  current cell from the padded per-cell face tables (mesh.cface/csign,
  [nC,K] — the same tables the FV stencil uses), advances to
  min(exit, remaining-time), and crosses into the neighbour cell /
  interacts with the boundary (wall -> specular rebound, patch ->
  escape). Convex cells assumed (the reference's tet-decomposition
  handles concavity; out of scope).
- Forces: sphere drag with the Schiller-Naumann correction
  (reference: intermediate/submodels/Kinematic/ParticleForces/
  SphereDragForce) + buoyant gravity, integrated semi-implicitly (the
  reference's analytical/Euler integration schemes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# boundary interaction codes per face (flat [nF])
BND_INTERNAL = 0
BND_WALL = 1       # specular rebound
BND_ESCAPE = 2     # leave the domain (patch/inlet/outlet)


class Cloud(NamedTuple):
    """Struct-of-arrays particle cloud ([Np] fixed slots)."""
    x: Any          # [Np,3] position
    u: Any          # [Np,3] velocity
    d: Any          # [Np] diameter
    rho: Any        # [Np] particle density
    cell: Any       # [Np] int32 current cell
    active: Any     # [Np] bool
    T: Any = None   # [Np] parcel temperature (thermo parcels)

    @property
    def n_active(self):
        return jnp.sum(self.active.astype(jnp.int32))


class CloudConfig(NamedTuple):
    rho_f: float = 1.0          # carrier density
    mu_f: float = 1.8e-5        # carrier dynamic viscosity
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    max_hops: int = 8           # face crossings per transport step
    drag: bool = True
    e_wall: float = 1.0         # wall restitution (1 = specular elastic)
    # thermo parcels (reference: ThermoParcel + RanzMarshall)
    solve_T: bool = False
    cp_p: float = 4186.0        # parcel specific heat
    k_f: float = 0.026          # carrier conductivity
    pr_f: float = 0.7           # carrier Prandtl number


def face_boundary_types(mesh) -> np.ndarray:
    """Flat [nF] interaction code from the patch types (host-side)."""
    bt = np.zeros(mesh.n_faces, dtype=np.int32)
    for p in mesh.patches:
        sl = p.slice
        if p.type in ("wall", "empty", "symmetry", "symmetryPlane",
                      "wedge"):
            bt[sl] = BND_WALL
        else:
            bt[sl] = BND_ESCAPE
    return bt


def locate_cells(mesh, x: np.ndarray) -> np.ndarray:
    """Host-side initial cell location: nearest cell centre (exact for
    points inside their nearest cell on reasonable meshes; the tracking
    walk self-corrects across faces afterwards)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(mesh.c))
    return tree.query(np.asarray(x))[1].astype(np.int32)


def make_cloud(mesh, x, u, d, rho, n_slots: Optional[int] = None,
               T0=300.0) -> Cloud:
    x = np.atleast_2d(np.asarray(x, dtype=float))
    n = x.shape[0]
    ns = n_slots or n
    dt = np.asarray(mesh.v).dtype

    def pad(a, shape, fill=0.0):
        out = np.full(shape, fill, dtype=float)
        out[:n] = a
        return jnp.asarray(out, dt)

    cells = np.zeros(ns, dtype=np.int32)
    cells[:n] = locate_cells(mesh, x)
    active = np.zeros(ns, dtype=bool)
    active[:n] = True
    return Cloud(
        x=pad(x, (ns, 3)),
        u=pad(np.broadcast_to(np.atleast_2d(u), (n, 3)), (ns, 3)),
        d=pad(np.broadcast_to(d, (n,)), (ns,), fill=1e-6),
        rho=pad(np.broadcast_to(rho, (n,)), (ns,), fill=1e3),
        cell=jnp.asarray(cells),
        active=jnp.asarray(active),
        T=pad(np.broadcast_to(T0, (n,)), (ns,), fill=300.0))


def _track(mesh, cloud: Cloud, dt, bt, cfg: CloudConfig) -> Cloud:
    """Geometric face-walk transport over one dt (all particles)."""
    K = mesh.cface.shape[1]
    eps = jnp.asarray(1e-12, mesh.v.dtype)
    big = jnp.asarray(1e30, mesh.v.dtype)

    def hop(_, carry):
        x, u, cell, active, trem = carry
        faces = mesh.cface[cell]                       # [Np,K]
        sgn = mesh.csign[cell]                         # [Np,K]
        n = mesh.sf[faces] * sgn[..., None]            # outward
        cfc = mesh.cf[faces]
        un = jnp.einsum("pkd,pd->pk", n, u)
        dist = jnp.einsum("pkd,pkd->pk", cfc - x[:, None, :], n)
        valid = (sgn != 0) & (un > 1e-30)
        lam = jnp.where(valid, dist / jnp.where(un == 0, 1.0, un), big)
        # lam == 0 (particle ON the face, moving outward) must cross —
        # a particle seeded exactly on a cell face would otherwise
        # tunnel with a stale cell index; un>0 prevents re-crossing back
        lam = jnp.where(lam >= 0, lam, big)
        kmin = jnp.argmin(lam, axis=1)
        lam_min = jnp.take_along_axis(lam, kmin[:, None], axis=1)[:, 0]
        moving = active & (trem > 0)
        t_adv = jnp.minimum(lam_min, trem)
        t_adv = jnp.where(moving, t_adv, 0.0)
        x = x + u * t_adv[:, None]
        crossed = moving & (lam_min < trem)
        f = jnp.take_along_axis(faces, kmin[:, None], axis=1)[:, 0]
        nb_valid = jnp.take_along_axis(mesh.cnbr_valid[cell],
                                       kmin[:, None], axis=1)[:, 0] > 0
        nb = jnp.take_along_axis(mesh.cnbr[cell], kmin[:, None],
                                 axis=1)[:, 0]
        code = bt[f]
        # internal crossing
        cell = jnp.where(crossed & nb_valid, nb, cell)
        # wall rebound: reflect u about the face normal
        nhat_k = jnp.take_along_axis(
            n, kmin[:, None, None].repeat(3, axis=2), axis=1)[:, 0, :]
        nn = nhat_k / jnp.maximum(
            jnp.linalg.norm(nhat_k, axis=1, keepdims=True), 1e-30)
        wall = crossed & (~nb_valid) & (code == BND_WALL)
        un_p = jnp.einsum("pd,pd->p", u, nn)
        u = jnp.where(wall[:, None],
                      u - (1.0 + cfg.e_wall) * un_p[:, None] * nn, u)
        # escape
        esc = crossed & (~nb_valid) & (code == BND_ESCAPE)
        active = active & (~esc)
        trem = jnp.maximum(trem - t_adv, 0.0)
        return x, u, cell, active, trem

    trem0 = jnp.where(cloud.active, dt, 0.0)
    x, u, cell, active, trem = jax.lax.fori_loop(
        0, cfg.max_hops, hop,
        (cloud.x, cloud.u, cloud.cell, cloud.active, trem0))
    # any remaining time: advance freely (deep inside a large cell)
    x = x + u * trem[:, None]
    return cloud._replace(x=x, u=u, cell=cell, active=active)


def _drag_update(cloud: Cloud, u_f, dt, cfg: CloudConfig) -> Cloud:
    """Semi-implicit velocity update with Schiller-Naumann sphere drag
    + buoyant gravity (reference: SphereDragForce::CdRe)."""
    g = jnp.asarray(cfg.g, cloud.u.dtype)
    if not cfg.drag:
        u_new = cloud.u + dt * g[None, :]
        return cloud._replace(u=u_new)
    urel = u_f - cloud.u
    mag = jnp.linalg.norm(urel, axis=1)
    Re = jnp.maximum(cfg.rho_f * mag * cloud.d / cfg.mu_f, 1e-10)
    CdRe = jnp.where(Re > 1000.0, 0.424 * Re,
                     24.0 * (1.0 + 0.15 * Re ** 0.687))
    # tau^-1 = (18 mu / (rho_p d^2)) * CdRe/24
    tau_inv = 18.0 * cfg.mu_f / (cloud.rho * cloud.d ** 2) * CdRe / 24.0
    geff = (1.0 - cfg.rho_f / cloud.rho)[:, None] * g[None, :]
    u_new = ((cloud.u + dt * (tau_inv[:, None] * u_f + geff))
             / (1.0 + dt * tau_inv)[:, None])
    return cloud._replace(u=jnp.where(cloud.active[:, None], u_new,
                                      cloud.u))


def _thermo_update(cloud: Cloud, u_f, T_f, dt, cfg: CloudConfig
                   ) -> Cloud:
    """Ranz-Marshall convective heating, semi-implicit (reference:
    intermediate/submodels/Thermodynamic/HeatTransferModel/
    RanzMarshall): Nu = 2 + 0.6 Re^1/2 Pr^1/3;
    dT/dt = 6 Nu k_f / (rho_p cp_p d^2) (T_f - T_p)."""
    urel = jnp.linalg.norm(u_f - cloud.u, axis=1)
    Re = jnp.maximum(cfg.rho_f * urel * cloud.d / cfg.mu_f, 1e-10)
    Nu = 2.0 + 0.6 * jnp.sqrt(Re) * cfg.pr_f ** (1.0 / 3.0)
    tau_inv = 6.0 * Nu * cfg.k_f / (cloud.rho * cfg.cp_p
                                    * cloud.d ** 2)
    T_new = (cloud.T + dt * tau_inv * T_f) / (1.0 + dt * tau_inv)
    return cloud._replace(T=jnp.where(cloud.active, T_new, cloud.T))


def evolve(mesh, cloud: Cloud, U_cell, dt, bt, cfg: CloudConfig,
           T_cell=None) -> Cloud:
    """One cloud step: drag/gravity velocity update at the particle's
    cell (+ optional Ranz-Marshall heating), then the geometric
    transport walk (reference: KinematicCloud::evolve)."""
    u_f = U_cell[cloud.cell]
    if cfg.solve_T and T_cell is not None and cloud.T is not None:
        cloud = _thermo_update(cloud, u_f, T_cell[cloud.cell], dt, cfg)
    cloud = _drag_update(cloud, u_f, dt, cfg)
    return _track(mesh, cloud, dt, bt, cfg)


def momentum_source(mesh, cloud_before: Cloud, cloud_after: Cloud,
                    n_parcels, dt, cfg: Optional[CloudConfig] = None):
    """Per-cell DRAG momentum transferred to the carrier [N] (two-way
    coupling, reference: KinematicParcel UTrans): the body-force
    (buoyant gravity) part of the parcel acceleration is NOT exchanged
    with the fluid — only the surface (drag) force reacts back, so it
    is subtracted from the observed m*dU/dt."""
    m = (cloud_after.rho * jnp.pi / 6.0 * cloud_after.d ** 3
         * n_parcels)
    dU = (cloud_after.u - cloud_before.u) / dt
    if cfg is not None:
        g = jnp.asarray(cfg.g, dU.dtype)
        geff = (1.0 - cfg.rho_f / cloud_after.rho)[:, None] * g[None, :]
        dU = dU - geff
    src = -(m[:, None] * dU)
    w = cloud_after.active.astype(src.dtype)[:, None]
    return jax.ops.segment_sum(src * w, cloud_after.cell,
                               num_segments=mesh.n_cells)


# ---------------------------------------------------------------------------
# Injection models (reference: src/lagrangian/intermediate/submodels/
# Kinematic/InjectionModel/ — patchInjection / coneNozzleInjection)
# ---------------------------------------------------------------------------


class InjectionConfig(NamedTuple):
    """Deterministic jit-safe injection: candidate positions/cells are
    precomputed host-side (patch face centres or cone nozzle points)
    and cycled; floor(rate*dt + carry) dead slots activate per step."""
    positions: Any     # [nPos,3]
    cells: Any         # [nPos] int32
    u0: Any            # [3] initial velocity
    d0: float = 1e-4
    rho0: float = 1000.0
    T0: float = 300.0
    rate: float = 0.0  # parcels per second


def patch_injection(mesh, patch_name: str, u0, d0=1e-4, rho0=1000.0,
                    rate=0.0, T0=300.0, offset=1e-6) -> InjectionConfig:
    """Inject at the face centres of a patch, nudged inward along the
    face normal (reference: patchInjection)."""
    p = mesh.patch(patch_name)
    cf = np.asarray(mesh.cf)[p.slice]
    sf = np.asarray(mesh.sf)[p.slice]
    n = sf / np.maximum(np.linalg.norm(sf, axis=1, keepdims=True), 1e-30)
    pos = cf - offset * n
    cells = np.asarray(mesh.owner)[p.slice]
    return InjectionConfig(
        positions=jnp.asarray(pos, mesh.v.dtype),
        cells=jnp.asarray(cells.astype(np.int32)),
        u0=jnp.asarray(u0, mesh.v.dtype), d0=d0, rho0=rho0, T0=T0,
        rate=rate)


def cone_injection(mesh, apex, direction, half_angle_deg, n_rays=16,
                   u_mag=1.0, d0=1e-4, rho0=1000.0, rate=0.0,
                   T0=300.0) -> InjectionConfig:
    """coneNozzleInjection-style: rays on the cone surface around
    `direction`, all from the apex."""
    d = np.asarray(direction, float)
    d /= max(np.linalg.norm(d), 1e-30)
    a = np.array([1.0, 0.0, 0.0])
    if abs(d @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    e1 = np.cross(d, a); e1 /= np.linalg.norm(e1)
    e2 = np.cross(d, e1)
    th = np.deg2rad(half_angle_deg)
    phis = np.linspace(0, 2 * np.pi, n_rays, endpoint=False)
    dirs = (np.cos(th) * d[None, :]
            + np.sin(th) * (np.cos(phis)[:, None] * e1[None, :]
                            + np.sin(phis)[:, None] * e2[None, :]))
    pos = np.broadcast_to(np.asarray(apex, float), (n_rays, 3)).copy()
    cells = locate_cells(mesh, pos)
    return InjectionConfig(
        positions=jnp.asarray(pos, mesh.v.dtype),
        cells=jnp.asarray(cells.astype(np.int32)),
        u0=jnp.asarray(u_mag * dirs, mesh.v.dtype), d0=d0, rho0=rho0,
        T0=T0, rate=rate)


def inject(cloud: Cloud, inj: InjectionConfig, carry, counter, dt):
    """Activate floor(rate*dt + carry) dead slots (jit-safe: dynamic
    count as a mask). Returns (cloud, new_carry, new_counter)."""
    want = inj.rate * dt + carry
    n_new = jnp.floor(want).astype(jnp.int32)
    new_carry = want - n_new
    npos = inj.positions.shape[0]
    ns = cloud.active.shape[0]
    # first-n dead slots: stable argsort puts active=False first
    order = jnp.argsort(cloud.active.astype(jnp.int32), stable=True)
    rank_of_slot = jnp.zeros(ns, jnp.int32).at[order].set(
        jnp.arange(ns, dtype=jnp.int32))
    take = (~cloud.active) & (rank_of_slot < n_new)
    src = (counter + rank_of_slot) % npos
    u0 = inj.u0 if inj.u0.ndim == 2 else jnp.broadcast_to(
        inj.u0, (npos, 3))
    tk = take[:, None]
    new = cloud._replace(
        x=jnp.where(tk, inj.positions[src], cloud.x),
        u=jnp.where(tk, u0[src % u0.shape[0]], cloud.u),
        d=jnp.where(take, inj.d0, cloud.d),
        rho=jnp.where(take, inj.rho0, cloud.rho),
        cell=jnp.where(take, inj.cells[src], cloud.cell),
        active=cloud.active | take,
        T=None if cloud.T is None else jnp.where(take, inj.T0, cloud.T))
    n_inj = jnp.sum(take.astype(jnp.int32))
    return new, new_carry, counter + n_inj
