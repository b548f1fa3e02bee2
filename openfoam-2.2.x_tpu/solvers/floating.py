"""floating — sixDoF rigid body coupled to incompressible flow.

Rebuild of reference: the sixDoFRigidBodyMotion motion solver coupled
into pimpleDyMFoam (tutorial: multiphase/interDyMFoam/floatingObject):
the flow's pressure+viscous forces on a body patch drive
sixDoFRigidBodyMotion::update, the mesh deforms with the body, and
the flow sees the motion through the ALE relative flux.

Design:
- The body state (models/sixdof.py symplectic quaternion integrator)
  lives in the jitted step's state pytree; forces come from the same
  patch-force kernel the forces functionObject uses.
- Mesh deformation: body displacement/rotation applied to the points
  with a radial blending weight (1 at the body, 0 beyond r_outer) —
  the reference's displacementLaplacian solve replaced by an explicit
  blend (same class of smooth extension, no extra solve).
- The mesh flux uses the DISCRETE swept-face form
  (cf_new - cf_old)/dt . 0.5 (Sf_new + Sf_old): closer to the
  geometric conservation law than evaluating an analytic mesh
  velocity (there is none — the motion is force-driven).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.dimensions import dimTime, dimViscosity
from ..core.fields import VolField
from ..mesh import moving
from ..models import sixdof
from ..ops import fvc, fvm, slot as slot_mod, surface
from . import linear
from .piso import boundary_flux, needs_reference


class FloatingConfig(NamedTuple):
    nu: float
    body: sixdof.RigidBodyConfig
    body_patch: int               # patch index of the rigid body
    x0: Tuple[float, float, float]   # initial centre of mass
    r_inner: float                # full-motion radius around the body
    r_outer: float                # zero-motion radius
    rho_ref: float = 1000.0       # flow density (kinematic p scaling)
    n_correctors: int = 2
    n_non_orth: int = 0
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    u_controls: Dict = None


def _blend_weight(r, r_inner, r_outer):
    t = jnp.clip((r - r_inner) / jnp.maximum(r_outer - r_inner,
                                             1e-30), 0.0, 1.0)
    return 0.5 * (1.0 + jnp.cos(jnp.pi * t))   # C1 falloff


def body_points(points0, x0, body: sixdof.RigidBodyState,
                r_inner, r_outer):
    """Deform the initial points with the body's rigid motion, blended
    to zero at r_outer from the INITIAL centre of mass."""
    x0 = jnp.asarray(x0, points0.dtype)
    r = jnp.linalg.norm(points0 - x0[None, :], axis=1)
    w = _blend_weight(r, r_inner, r_outer)
    rel = points0 - x0[None, :]
    rot = jax.vmap(lambda v: sixdof.quat_rotate(body.q, v))(rel)
    moved = body.x[None, :] + rot
    return points0 + w[:, None] * (moved - points0)


def patch_force_torque(mesh_t, p_data, U: VolField, nu, rho_ref,
                       patch, about):
    """Pressure + viscous force and torque on a patch (reference:
    forces functionObject; kinematic p -> multiply by rho_ref)."""
    sl = patch.slice
    sf = mesh_t.sf[sl]
    own = mesh_t.owner[sl]
    # pressure: p on the boundary ~ owner-cell value (zeroGradient)
    fp = rho_ref * p_data[own][:, None] * sf
    # viscous: tau = -rho nu dU/dn (wall: U_wall - U_c) * |Sf|/delta
    dcoef = mesh_t.delta_coeffs[sl]
    nif = mesh_t.n_internal_faces
    U_b = U.boundary_values(mesh_t)[sl.start - nif:sl.stop - nif]
    dU = (U_b - U.data[own]) * dcoef[:, None]
    fv = -rho_ref * nu * dU * mesh_t.mag_sf[sl][:, None]
    f = fp + fv
    F = jnp.sum(f, axis=0)
    r = mesh_t.cf[sl] - about[None, :]
    tau = jnp.sum(jnp.cross(r, f), axis=0)
    return F, tau


def floating_step(mesh, state: Dict, dt: Any, cfg: FloatingConfig
                  ) -> Tuple[Dict, Dict]:
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-7, "relTol": 0.01,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab",
                                "tolerance": 1e-6, "relTol": 0.1,
                                "maxIter": 200}
    U: VolField = state["U"]
    p: VolField = state["p"]
    phi = state["phi"]            # relative volumetric flux
    topo = state["topo"]
    body: sixdof.RigidBodyState = state["body"]
    rdt = 1.0 / dt
    diag: Dict[str, Any] = {}

    # ---- 1. flow forces on the body, 6-DoF update -----------------------------
    patch = mesh.patches[cfg.body_patch]
    points_old = state["points"]
    mesh_old = moving.update_geometry(mesh, points_old, topo)
    F, tau = patch_force_torque(mesh_old, p.data, U, cfg.nu,
                                cfg.rho_ref, patch, body.x)
    body = sixdof.update(cfg.body, body, dt, f_ext=F, tau_ext=tau)
    diag["body_x"] = body.x
    diag["body_v"] = body.v
    diag["force"] = F

    # ---- 2. mesh motion + discrete swept mesh flux ----------------------------
    points = body_points(state["points0"], cfg.x0, body,
                         cfg.r_inner, cfg.r_outer)
    mesh_t = moving.update_geometry(mesh, points, topo)
    mesh_phi = (jnp.einsum(
        "fd,fd->f", (mesh_t.cf - mesh_old.cf) * rdt,
        0.5 * (mesh_t.sf + mesh_old.sf)) * mesh_t.face_active)
    nif = mesh_t.n_internal_faces

    phi_slot = slot_mod.from_flat(mesh_t, phi)
    mp_slot = slot_mod.from_flat(mesh_t, mesh_phi)

    # ---- 3. PISO on the moving mesh (as pimpledym) -----------------------------
    UEqn = (fvm.ddt(mesh_t, U, state["U0"], rdt)
            + fvm.div(mesh_t, phi, U, phi_slot=phi_slot)
            - fvm.laplacian(mesh_t, jnp.asarray(cfg.nu, mesh_t.v.dtype),
                            U, corrected=False,
                            gamma_dims=dimViscosity))
    grad_p = fvc.grad_of(mesh_t, p, "Gauss linear")
    Udata, uperf = linear.solve(mesh_t, UEqn.add_source(-grad_p,
                                                        mesh_t),
                                U.data, u_ctrl)
    U = U.with_data(Udata)
    diag["Ux"] = uperf

    rA = 1.0 / UEqn.A(mesh_t)
    rAf_slot = slot_mod.interpolate(mesh_t, rA,
                                    bv=surface.owner_to_b(mesh_t, rA))
    rAf = slot_mod.to_flat(mesh_t, rAf_slot)
    pEqn0 = fvm.laplacian(mesh_t, rAf, p, corrected=False,
                          gamma_dims=dimTime, gamma_slot=rAf_slot)
    p_ctrl_p = linear.prepare_controls(mesh_t, pEqn0, p_ctrl)
    closed = needs_reference(p, mesh_t)

    # the body patch moves: its boundary flux is the BODY's swept flux
    bsl = slice(patch.slice.start - nif, patch.slice.stop - nif)
    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh_t, U.data)
        hba = slot_mod.flux_of(mesh_t, HbyA,
                               bv=boundary_flux(mesh_t, U))
        phiHbyA = slot_mod.SlotFace(hba.sv - mp_slot.sv,
                                    hba.fb - mp_slot.fb,
                                    jnp.zeros_like(hba.bv))
        pEqn = pEqn0.replace_fields(
            source=pEqn0.source
            + slot_mod.surface_sum(mesh_t, phiHbyA))
        pEqn, ctl = linear.prep_pressure(pEqn, closed, p_ctrl_p,
                                         cfg.p_ref_cell,
                                         cfg.p_ref_value)
        pdata, pperf = linear.solve(mesh_t, pEqn, p.data, ctl)
        p = p.with_data(pdata)
        if corr == 0:
            diag["p_initial"] = pperf.initial_residual
        diag["p_final"] = pperf.final_residual
        Fl = slot_mod.laplacian_flux(mesh_t, rAf_slot, p.data,
                                     corrected=False, corr=None)
        p_bc = surface.owner_to_b(mesh_t, p.data)
        F_b = pEqn.ic * p_bc - pEqn.bc
        phi_slot = slot_mod.SlotFace(phiHbyA.sv - Fl.sv,
                                     phiHbyA.fb - Fl.fb,
                                     phiHbyA.bv - F_b)
        grad_p = fvc.grad_of(mesh_t, p, "Gauss linear")
        U = U.with_data(HbyA - rA[:, None] * grad_p)
        # no-slip on the moving body: U = body velocity at each face
        r = mesh_t.cf[patch.slice] - body.x[None, :]
        I = jnp.asarray(cfg.body.I_body, U.data.dtype)
        om_b = sixdof.quat_rotate(sixdof._conj(body.q), body.L) / I
        om_g = sixdof.quat_rotate(body.q, om_b)
        u_body = body.v[None, :] + jnp.cross(
            jnp.broadcast_to(om_g, r.shape), r)
        bcs = list(U.bcs)
        bc = bcs[cfg.body_patch]
        bcs[cfg.body_patch] = bc.replace(ref_value=u_body)
        import dataclasses as _dc

        U = _dc.replace(U, bcs=tuple(bcs))
        U = U.correct_boundary_conditions(mesh_t)
    phi = slot_mod.to_flat(mesh_t, phi_slot)

    div_phi = slot_mod.surface_sum(mesh_t, phi_slot)
    diag["continuity"] = jnp.sum(jnp.abs(div_phi)) / jnp.sum(mesh_t.v)
    diag["v_min"] = jnp.min(mesh_t.v)

    new_state = dict(state)
    new_state.update(U=U, p=p, phi=phi, U0=U.data, body=body,
                     points=points)
    return new_state, diag


def initial_state(pm, mesh, U: VolField, p: VolField,
                  cfg: FloatingConfig,
                  body: Optional[sixdof.RigidBodyState] = None
                  ) -> Dict:
    topo = moving.topo_from_poly(pm, mesh.v.dtype)
    pts0 = jnp.asarray(pm.points, mesh.v.dtype)
    if body is None:
        body = sixdof.initial_state(x=cfg.x0, dtype=mesh.v.dtype)
    return {"U": U, "p": p, "phi": fvc.flux(mesh, U), "U0": U.data,
            "points0": pts0, "points": pts0, "topo": topo,
            "body": body}


def make_step(mesh, cfg: FloatingConfig):
    return jax.jit(lambda state, dt: floating_step(mesh, state, dt,
                                                   cfg))
