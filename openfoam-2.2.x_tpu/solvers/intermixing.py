"""interMixingFoam — three incompressible phases, two of them miscible.

Rebuild of reference: applications/solvers/multiphase/interMixingFoam/
(threePhaseMixture, threePhaseInterfaceProperties, alphaEqns.H).
Phase 1 = air (immiscible, MULES-compressed against the liquids);
phases 2 and 3 are miscible liquids exchanging by Fickian diffusion
with the composite diffusivity Dab + alphaDiffusion inside the liquid
region (reference: alphaEqns.H's D23 term).

Design: alpha1 runs the same MULES compression kernel as interFoam
(interfoam.alpha_step); alpha2 advects with an upwind bounded flux and
an explicit D23 laplacian, then alpha3 = 1 - alpha1 - alpha2 (exactly
as the reference closes the triple). Mixture rho/mu are 3-phase
weighted; the PISO loop is interFoam's.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.dimensions import DimensionSet, dimDensity, dimTime, dimViscosity
from ..core.fields import VolField
from ..models import interface as iface
from ..ops import fvc, fvm, surface
from . import linear
from .interfoam import InterConfig, alpha_step
from .piso import (boundary_flux, div_weights, face_interp_cell,
                   needs_reference)


class InterMixingConfig(NamedTuple):
    flow: InterConfig            # rho1/nu1 = air; rho2/nu2 = liquid A
    rho3: float = 1000.0         # liquid B
    nu3: float = 1e-6
    D23: float = 3e-9            # binary diffusivity liquid A <-> B


def mixture3(cfg: InterMixingConfig, a1, a2):
    f = cfg.flow
    a1 = jnp.clip(a1, 0.0, 1.0)
    a2 = jnp.clip(a2, 0.0, 1.0)
    a3 = jnp.clip(1.0 - a1 - a2, 0.0, 1.0)
    rho = a1 * f.rho1 + a2 * f.rho2 + a3 * cfg.rho3
    mu = (a1 * f.rho1 * f.nu1 + a2 * f.rho2 * f.nu2
          + a3 * cfg.rho3 * cfg.nu3)
    return rho, mu, a3


def intermixing_step(mesh, state: Dict, dt: Any,
                     cfg: InterMixingConfig) -> Tuple[Dict, Dict]:
    f = cfg.flow
    p_ctrl = f.p_controls or {"solver": "PCG", "tolerance": 1e-7,
                              "relTol": 0.05}
    u_ctrl = f.u_controls or {"solver": "PBiCGStab", "tolerance": 1e-7,
                              "relTol": 0.0, "maxIter": 200}
    U: VolField = state["U"]
    p_rgh: VolField = state["p_rgh"]
    alpha1: VolField = state["alpha1"]
    alpha2: VolField = state["alpha2"]
    phi = state["phi"]
    rho_old = state["rho"]
    rdt = 1.0 / dt
    nif = mesh.n_internal_faces
    diag: Dict[str, Any] = {}

    g = jnp.asarray(f.g, mesh.v.dtype)
    ghf = mesh.cf @ g

    # ---- alpha1: MULES with interface compression (air vs liquids) ----------
    alpha1, _ = alpha_step(mesh, alpha1, phi, dt, f)

    # ---- alpha2: bounded upwind advection + D23 diffusion --------------------
    a2 = alpha2.data
    w_up = jnp.where(phi[:nif] >= 0, 1.0, 0.0).astype(a2.dtype)
    a2f_i = surface.interpolate_internal(mesh, a2, w_up)
    a2b = alpha2.boundary_values(mesh)
    a2f = jnp.concatenate([a2f_i, a2b], axis=0)
    adv = surface.surface_sum(mesh, phi * a2f * mesh.face_active)
    # D23 diffusion only within the liquid region (scaled by 1-alpha1,
    # the reference's alpha-weighted D)
    lam_liq = jnp.clip(1.0 - alpha1.data, 0.0, 1.0)
    D_f = cfg.D23 * face_interp_cell(mesh, lam_liq)
    sng_a2 = fvc.sn_grad(mesh, alpha2)
    diff = surface.surface_sum(
        mesh, D_f * sng_a2 * mesh.mag_sf * mesh.face_active)
    a2_new = a2 + dt * (-adv + diff) / mesh.v
    # boundedness: alpha2 in [0, 1 - alpha1]
    a2_new = jnp.clip(a2_new, 0.0, jnp.clip(1.0 - alpha1.data, 0.0,
                                            1.0))
    alpha2 = alpha2.with_data(a2_new)

    rho, mu, a3 = mixture3(cfg, alpha1.data, alpha2.data)
    rho_f = face_interp_cell(mesh, rho)
    rho_phi = phi * rho_f
    diag["alpha1_range"] = (jnp.min(alpha1.data), jnp.max(alpha1.data))
    diag["alpha2_sum"] = jnp.sum(alpha2.data * mesh.v)
    diag["alpha3_min"] = jnp.min(a3)

    # ---- momentum (interFoam's variable-density form) ------------------------
    mu_f = face_interp_cell(mesh, mu)
    w_div = div_weights(mesh, rho_phi, "vanLeer", U)
    ddt_mat = fvm.ddt(mesh, U, state["U0"], rdt)
    ddt_mat = ddt_mat.replace_fields(
        diag=ddt_mat.diag * rho,
        source=ddt_mat.source * rho_old[:, None],
        dims=ddt_mat.dims * dimDensity)
    UEqn = (ddt_mat
            + fvm.div(mesh, rho_phi, U, weights=w_div,
                      phi_dims=DimensionSet.of(1, 0, -1))
            - fvm.laplacian(mesh, mu_f, U, corrected=f.corrected,
                            gamma_dims=dimViscosity * dimDensity))
    st_flux = iface.surface_tension_flux(mesh, alpha1, f.sigma)
    from ..bc.patchfields import default_bcs

    sng_rho = fvc.sn_grad(mesh, VolField(
        data=rho, bcs=default_bcs(mesh, rank=0), name="rho",
        dims=dimDensity))
    buoy_flux = -ghf * sng_rho * mesh.mag_sf * mesh.face_active
    grad_prgh = fvc.grad(mesh, p_rgh)
    if f.momentum_predictor:
        rhs_cell = fvc.reconstruct(mesh, st_flux + buoy_flux) - grad_prgh
        Udata, uperf = linear.solve(
            mesh, UEqn.add_source(rhs_cell, mesh), U.data, u_ctrl)
        U = U.with_data(Udata)
        diag["Ux"] = uperf

    # ---- PISO on p_rgh --------------------------------------------------------
    rA = 1.0 / UEqn.A(mesh)
    rAf = face_interp_cell(mesh, rA)
    p_rgh = p_rgh.correct_boundary_conditions(mesh, phi=phi, U=U.data,
                                              rho_b=rho)
    for corr in range(f.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh, U.data)
        hf = surface.interpolate_internal(mesh, HbyA)
        phiHbyA_i = jnp.sum(mesh.sf[:nif] * hf, axis=1) \
            * mesh.face_active[:nif]
        phiHbyA = jnp.concatenate([phiHbyA_i, boundary_flux(mesh, U)],
                                  axis=0)
        phig = rAf * (st_flux + buoy_flux)
        phiHbyA = phiHbyA + phig
        for nonorth in range(f.n_non_orth + 1):
            pEqn = fvm.laplacian(mesh, rAf, p_rgh,
                                 corrected=f.corrected,
                                 gamma_dims=dimTime)
            pEqn = pEqn.replace_fields(
                source=pEqn.source + surface.surface_sum(mesh, phiHbyA))
            pEqn, ctl_p = linear.prep_pressure(
                pEqn, needs_reference(p_rgh, mesh), p_ctrl,
                f.p_ref_cell, f.p_ref_value)
            pdata, pperf = linear.solve(mesh, pEqn, p_rgh.data, ctl_p)
            p_rgh = p_rgh.with_data(pdata)
            if corr == 0 and nonorth == 0:
                diag["p_initial"] = pperf.initial_residual
                diag["p_iters"] = pperf.n_iterations
            diag["p_final"] = pperf.final_residual
            if nonorth == f.n_non_orth:
                phi = phiHbyA - pEqn.flux(mesh, p_rgh.data)
        pflux = pEqn.flux(mesh, p_rgh.data)
        U = U.with_data(HbyA + rA[:, None] * fvc.reconstruct(
            mesh, (phig - pflux) / jnp.maximum(rAf, 1e-30)))
        U = U.correct_boundary_conditions(mesh, phi=phi)

    div_phi = surface.surface_sum(mesh, phi)
    diag["continuity"] = jnp.sum(jnp.abs(div_phi)) / jnp.sum(mesh.v)

    new_state = dict(state)
    new_state.update(U=U, p_rgh=p_rgh, alpha1=alpha1, alpha2=alpha2,
                     phi=phi, rho=rho, U0=U.data)
    return new_state, diag


def initial_state(mesh, U: VolField, p_rgh: VolField, alpha1: VolField,
                  alpha2: VolField, cfg: InterMixingConfig) -> Dict:
    rho, _, _ = mixture3(cfg, alpha1.data, alpha2.data)
    return {"U": U, "p_rgh": p_rgh, "alpha1": alpha1, "alpha2": alpha2,
            "phi": fvc.flux(mesh, U), "rho": rho, "U0": U.data}


def make_step(mesh, cfg: InterMixingConfig):
    return jax.jit(lambda state, dt: intermixing_step(mesh, state, dt,
                                                      cfg))
