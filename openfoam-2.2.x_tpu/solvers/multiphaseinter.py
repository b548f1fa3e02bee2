"""multiphaseInterFoam — N immiscible incompressible phases with
MULES-bounded fractions and pairwise interface compression.

Rebuild of reference: applications/solvers/multiphase/
multiphaseInterFoam/ (multiphaseMixture::solveAlphas — sequential
per-phase MULES with pairwise compression fluxes, mixture transport,
pairwise CSF surface tension) on the p_rgh PISO of interFoam.

Design: the phase fractions live as one [nC, nP] array; every
phase's bounded advection and all pairwise compression terms evaluate
batched; a final renormalisation enforces sum(alpha)=1 (the
reference's solveAlphas does the same normalisation).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.dimensions import DimensionSet, dimDensity, dimTime, dimViscosity
from ..core.fields import VolField
from ..models import interface as iface
from ..ops import fvc, fvm, mules, surface
from . import linear
from .piso import (boundary_flux, div_weights, face_interp_cell,
                   needs_reference)


class MultiphaseConfig(NamedTuple):
    rhos: Tuple[float, ...]          # [nP]
    nus: Tuple[float, ...]           # [nP]
    sigmas: Dict = None              # {(i,j): sigma}
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    c_alpha: float = 1.0
    n_correctors: int = 3
    n_non_orth: int = 0
    momentum_predictor: bool = True
    corrected: bool = False
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    u_controls: Dict = None
    # MRFMultiphaseInterFoam (reference: the multiphaseInterFoam MRF
    # variant): rotating zones from constant/MRFZones
    mrf: Any = None


def mixture(cfg: MultiphaseConfig, alphas: Any):
    a = jnp.clip(alphas, 0.0, 1.0)
    rhos = jnp.asarray(cfg.rhos, a.dtype)
    nus = jnp.asarray(cfg.nus, a.dtype)
    rho = a @ rhos
    mu = a @ (rhos * nus)
    return rho, mu


def _phase_field(alpha: VolField, data_i) -> VolField:
    return alpha.with_data(data_i)


def multiphase_step(mesh, state: Dict, dt: Any, cfg: MultiphaseConfig
                    ) -> Tuple[Dict, Dict]:
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-7, "relTol": 0.05,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab", "tolerance": 1e-7,
                                "relTol": 0.0, "maxIter": 200}
    U: VolField = state["U"]
    p_rgh: VolField = state["p_rgh"]
    alpha: VolField = state["alphas"]     # [nC, nP], shared bcs
    phi = state["phi"]
    rho_old = state["rho"]
    rdt = 1.0 / dt
    nif = mesh.n_internal_faces
    nP = len(cfg.rhos)
    diag: Dict[str, Any] = {}
    g = jnp.asarray(cfg.g, mesh.v.dtype)
    ghf = mesh.cf @ g

    # ---- solveAlphas: per-phase MULES with pairwise compression ------------
    A = alpha.data
    new_cols = []
    for i in range(nP):
        ai = _phase_field(alpha, A[:, i])
        abv = ai.boundary_values(mesh)
        w_up = jnp.where(phi[:nif] >= 0, 1.0, 0.0).astype(A.dtype)
        af_up = jnp.concatenate(
            [surface.interpolate_internal(mesh, A[:, i], w_up), abv],
            axis=0)
        phi_bd = phi * af_up * mesh.face_active
        af_lin = jnp.concatenate(
            [surface.interpolate_internal(mesh, A[:, i]), abv], axis=0)
        # pairwise compression: sum_j phir_ij * ai_f * aj_f with
        # phir_ij = cAlpha |phi|/|Sf| nHatf(ai - aj)
        comp = jnp.zeros_like(phi)
        for j in range(nP):
            if j == i:
                continue
            aj = _phase_field(alpha, A[:, j])
            phir = iface.compression_flux(
                mesh, phi, _phase_field(alpha, A[:, i] - A[:, j]),
                cfg.c_alpha)
            ajf = jnp.concatenate(
                [surface.interpolate_internal(mesh, A[:, j]),
                 aj.boundary_values(mesh)], axis=0)
            comp = comp + phir * af_lin * ajf
        phi_ho = (phi * af_lin + comp) * mesh.face_active
        a_new, _ = mules.explicit_solve(
            mesh, A[:, i], phi_bd, phi_ho - phi_bd, dt,
            psi_max=1.0, psi_min=0.0)
        new_cols.append(a_new)
    A = jnp.stack(new_cols, axis=1)
    A = A / jnp.maximum(jnp.sum(A, axis=1, keepdims=True), 1e-6)
    alpha = alpha.with_data(A)
    diag["alpha_min"] = jnp.min(A)
    diag["alpha_max"] = jnp.max(A)

    rho, mu = mixture(cfg, A)
    rho_phi = phi * face_interp_cell(mesh, rho)

    # ---- surface tension: pairwise CSF --------------------------------------
    st_flux = jnp.zeros_like(phi)
    sigmas = cfg.sigmas or {}
    for (i, j), sig in sigmas.items():
        if sig == 0.0:
            continue
        st_flux = st_flux + iface.surface_tension_flux(
            mesh, _phase_field(alpha, A[:, i]), float(sig))

    # ---- momentum -----------------------------------------------------------
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
            - fvm.laplacian(mesh, mu_f, U, corrected=cfg.corrected,
                            gamma_dims=dimViscosity * dimDensity))
    if cfg.mrf:
        UEqn = cfg.mrf.add_coriolis(mesh, UEqn, U, rho=rho)
    from ..bc.patchfields import default_bcs

    sng_rho = fvc.sn_grad(mesh, VolField(
        data=rho, bcs=default_bcs(mesh, rank=0), name="rho",
        dims=dimDensity))
    buoy_flux = -ghf * sng_rho * mesh.mag_sf * mesh.face_active
    grad_prgh = fvc.grad(mesh, p_rgh)
    if cfg.momentum_predictor:
        rhs_cell = fvc.reconstruct(mesh, st_flux + buoy_flux) - grad_prgh
        Umat = UEqn.add_source(rhs_cell, mesh)
        Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
        U = U.with_data(Udata)
        diag["Ux"] = uperf

    # ---- PISO on p_rgh ------------------------------------------------------
    rA = 1.0 / UEqn.A(mesh)
    rAf = face_interp_cell(mesh, rA)
    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh, U.data)
        hf = surface.interpolate_internal(mesh, HbyA)
        phiHbyA_i = jnp.sum(mesh.sf[:nif] * hf, axis=1) \
            * mesh.face_active[:nif]
        phiHbyA = jnp.concatenate(
            [phiHbyA_i, boundary_flux(mesh, U)], axis=0)
        if cfg.mrf:
            phiHbyA = cfg.mrf.make_relative_flat(mesh, phiHbyA)
        phig = rAf * (st_flux + buoy_flux)
        phiHbyA = phiHbyA + phig
        for nonorth in range(cfg.n_non_orth + 1):
            pEqn = fvm.laplacian(mesh, rAf, p_rgh,
                                 corrected=cfg.corrected,
                                 gamma_dims=dimTime)
            pEqn = pEqn.replace_fields(
                source=pEqn.source + surface.surface_sum(mesh, phiHbyA))
            pEqn, ctl_p = linear.prep_pressure(
                pEqn, needs_reference(p_rgh, mesh), p_ctrl,
                cfg.p_ref_cell, cfg.p_ref_value)
            pdata, pperf = linear.solve(mesh, pEqn, p_rgh.data, ctl_p)
            p_rgh = p_rgh.with_data(pdata)
            if corr == 0 and nonorth == 0:
                diag["p_initial"] = pperf.initial_residual
                diag["p_iters"] = pperf.n_iterations
            diag["p_final"] = pperf.final_residual
            if nonorth == cfg.n_non_orth:
                phi = phiHbyA - pEqn.flux(mesh, p_rgh.data)
        pflux = pEqn.flux(mesh, p_rgh.data)
        U = U.with_data(
            HbyA + rA[:, None] * fvc.reconstruct(
                mesh, (phig - pflux) / jnp.maximum(rAf, 1e-30)))
        U = U.correct_boundary_conditions(mesh, phi=phi)

    div_phi = surface.surface_sum(mesh, phi)
    diag["continuity"] = jnp.sum(jnp.abs(div_phi)) / jnp.sum(mesh.v)
    sum_phi = jnp.sum(jnp.abs(phi)[mesh.cface] * jnp.abs(mesh.csign),
                      axis=1)
    diag["courant_max"] = 0.5 * jnp.max(sum_phi / mesh.v) * dt

    new_state = dict(state)
    new_state.update(U=U, p_rgh=p_rgh, alphas=alpha, phi=phi, rho=rho,
                     U0=U.data)
    return new_state, diag


def initial_state(mesh, U: VolField, p_rgh: VolField,
                  alphas: VolField, cfg: MultiphaseConfig) -> Dict:
    rho, _ = mixture(cfg, alphas.data)
    return {"U": U, "p_rgh": p_rgh, "alphas": alphas,
            "phi": fvc.flux(mesh, U), "rho": rho, "U0": U.data}


def make_step(mesh, cfg: MultiphaseConfig):
    from .jitstep import jit_with_mesh

    return jit_with_mesh(
        lambda m, state, dt: multiphase_step(m, state, dt, cfg), mesh,
        (cfg.p_controls, cfg.u_controls))
