"""compressibleInterFoam — two compressible, immiscible phases with a
MULES-bounded VOF interface.

Rebuild of reference: applications/solvers/multiphase/
compressibleInterFoam/ (alphaEqn.H with the dgdt compression source,
UEqn.H, TEqn.H, pEqn.H with the per-phase compressibility
contributions). Phase EOS as in the depthCharge tutorials:

  air   (phase 1): perfectGas      rho1 = psi1 p,        psi1 = 1/(R1 T)
  water (phase 2): perfectFluid    rho2 = rho0 + psi2 p, psi2 = 1/(R2 T)

Design: one jitted step; alpha MULES + compression on the flat
face layout (shared with interFoam), pressure equation with the
implicit mixture-compressibility ddt term

    (alpha1 psi1/rho1 + alpha2 psi2/rho2) rho V d(p_rgh)/dt
      + div(phiHbyA) - laplacian(rAUf, p_rgh) = comp. transport source

and the phase-exchange rate dgdt = alpha1 alpha2 (psi2/rho2 -
psi1/rho1) Dp/Dt fed back into the alpha equation as the reference's
compressibility dilatation source (documented simplification: Sp-form
explicit, T-induced density change enters through psi(T)).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.dimensions import (DimensionSet, dimDensity, dimTime,
                               dimViscosity)
from ..core.fields import VolField
from ..models import interface as iface
from ..ops import fvc, fvm, mules, surface
from . import linear
from .piso import (boundary_flux, div_weights, face_interp_cell,
                   needs_reference)


class CompIntConfig(NamedTuple):
    # phase 1 (gas): perfectGas R1; phase 2 (liquid): perfectFluid
    R1: float = 287.0
    R2: float = 3000.0
    rho0_2: float = 1000.0        # perfectFluid rho0 of the liquid
    nu1: float = 1.5e-5
    nu2: float = 1e-6
    Cv1: float = 718.0
    Cv2: float = 4186.0
    sigma: float = 0.07
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    c_alpha: float = 1.0
    n_alpha_subcycles: int = 1
    n_correctors: int = 3
    n_non_orth: int = 0
    momentum_predictor: bool = True
    corrected: bool = False
    p_min: float = 1000.0
    p_controls: Dict = None
    u_controls: Dict = None
    t_controls: Dict = None
    solve_T: bool = True
    # EOS evaluated at the fixed reference temperature (isothermal
    # compressibility). The mixture ddt(rho,T)/div(rhoPhi,T)
    # commutation error at the sharp interface otherwise feeds f32
    # temperature noise straight into rho1 = p/(R1 T) — documented
    # deviation from the reference's full psiThermo coupling.
    eos_isothermal: bool = True
    T_ref: float = 300.0


def phase_props(cfg: CompIntConfig, p: Any, T: Any):
    """(rho1, rho2, psi1, psi2) from the phase EOS."""
    if cfg.eos_isothermal:
        Ts = jnp.asarray(cfg.T_ref, jnp.asarray(p).dtype)
    else:
        Ts = jnp.maximum(T, 1.0)
    psi1 = 1.0 / (cfg.R1 * Ts)
    psi2 = 1.0 / (cfg.R2 * Ts)
    rho1 = jnp.maximum(psi1 * p, 1e-3)
    rho2 = jnp.maximum(cfg.rho0_2 + psi2 * p, 1e-2)
    return rho1, rho2, psi1, psi2


def mixture_rho(cfg: CompIntConfig, alpha: Any, p: Any, T: Any):
    a = jnp.clip(alpha, 0.0, 1.0)
    rho1, rho2, psi1, psi2 = phase_props(cfg, p, T)
    rho = a * rho1 + (1.0 - a) * rho2
    mu = a * rho1 * cfg.nu1 + (1.0 - a) * rho2 * cfg.nu2
    return rho, mu, rho1, rho2, psi1, psi2


def compint_step(mesh, state: Dict, dt: Any, cfg: CompIntConfig
                 ) -> Tuple[Dict, Dict]:
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-8, "relTol": 0.01,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab", "tolerance": 1e-7,
                                "relTol": 0.0, "maxIter": 200}
    t_ctrl = cfg.t_controls or u_ctrl
    U: VolField = state["U"]
    p_rgh: VolField = state["p_rgh"]
    T: VolField = state["T"]
    alpha: VolField = state["alpha"]
    phi = state["phi"]            # VOLUMETRIC flux
    rho_old = state["rho"]
    p_abs_old = state["p_abs"]
    rdt = 1.0 / dt
    nif = mesh.n_internal_faces
    diag: Dict[str, Any] = {}

    g = jnp.asarray(cfg.g, mesh.v.dtype)
    gh = mesh.c @ g
    ghf = mesh.cf @ g

    # ---- alpha advection (MULES + dilatation source) -----------------------
    # phase-1 continuity d(a rho1)/dt + div(u a rho1) = 0 rearranged:
    #   da/dt + div(u a) = a div(u) - a (psi1/rho1) Dp/Dt
    # (reference: compressibleInterFoam alphaEqns.H — the divU Sp term
    # + the dgdt compressibility exchange). divU and dp/dt lag one
    # step (explicit coupling, as the reference's dgdt field).
    a = alpha.data
    dgdt = state.get("dgdt", jnp.zeros_like(a))
    div_u = surface.surface_sum(mesh, phi) / mesh.v
    sub_dt = dt / cfg.n_alpha_subcycles
    rho_phi = jnp.zeros_like(phi)
    rho1o, rho2o, psi1o, _ = phase_props(cfg, p_abs_old, T.data)
    for _ in range(cfg.n_alpha_subcycles):
        phir = iface.compression_flux(mesh, phi, alpha.with_data(a),
                                      cfg.c_alpha)
        w_up = jnp.where(phi[:nif] >= 0, 1.0, 0.0).astype(a.dtype)
        af_up_i = surface.interpolate_internal(mesh, a, w_up)
        ab = alpha.with_data(a).boundary_values(mesh)
        af_up = jnp.concatenate([af_up_i, ab], axis=0)
        phi_bd = phi * af_up * mesh.face_active
        af_lin_i = surface.interpolate_internal(mesh, a)
        af_lin = jnp.concatenate([af_lin_i, ab], axis=0)
        a1f_i = surface.interpolate_internal(mesh, 1.0 - a)
        a1f = jnp.concatenate([a1f_i, 1.0 - ab], axis=0)
        phi_ho = (phi * af_lin + phir * af_lin * a1f) * mesh.face_active
        phi_corr = phi_ho - phi_bd
        a_new, phi_alpha = mules.explicit_solve(
            mesh, a, phi_bd, phi_corr, sub_dt, psi_max=1.0, psi_min=0.0)
        a = jnp.clip(a_new + sub_dt * a * (div_u + dgdt), 0.0, 1.0)
        rho_phi = rho_phi + (
            phi_alpha * (rho1o - rho2o)[mesh.owner]
            + phi * rho2o[mesh.owner]) / cfg.n_alpha_subcycles
    alpha = alpha.with_data(a)
    diag["alpha_min"] = jnp.min(a)
    diag["alpha_max"] = jnp.max(a)

    rho, mu, rho1, rho2, psi1, psi2 = mixture_rho(
        cfg, a, p_abs_old, T.data)

    # ---- momentum ----------------------------------------------------------
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
    st_flux = iface.surface_tension_flux(mesh, alpha, cfg.sigma)
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

    # ---- temperature (reference: TEqn.H; simplified pressure work) ---------
    if cfg.solve_T:
        phi_slot_w = div_weights(mesh, rho_phi, "upwind", T)
        TEqn = (fvm.ddt(mesh, T, state["T0"], rdt).replace_fields(
                    diag=mesh.v * rho * rdt,
                    source=mesh.v * rho_old * rdt * state["T0"],
                    dims=T.dims * DimensionSet.of(1, 0, -1))
                + fvm.div(mesh, rho_phi, T, weights=phi_slot_w,
                          phi_dims=DimensionSet.of(1, 0, -1))
                - fvm.laplacian(mesh, mu_f, T, corrected=False,
                                gamma_dims=dimViscosity * dimDensity))
        # compression work / mixture Cv: -p div(u) (a1/Cv1 + a2/Cv2).
        # The reference uses div(phi, p) + K-transport (TEqn.H); the
        # p*divU form keeps the same compression physics but avoids the
        # f32 noise of differencing p across the interface jump
        # (documented deviation: u.grad(p) advective work omitted).
        cv_mix_inv = a / cfg.Cv1 + (1.0 - a) / cfg.Cv2
        pw = -p_abs_old * div_u
        TEqn = TEqn.add_source(pw * cv_mix_inv, mesh)
        Tdata, tperf = linear.solve(mesh, TEqn, T.data, t_ctrl)
        T = T.with_data(jnp.maximum(Tdata, 1.0))
        T = T.correct_boundary_conditions(mesh)
        diag["T"] = tperf

    # ---- p_rgh (mixture compressibility) -----------------------------------
    rA = 1.0 / UEqn.A(mesh)
    rAf = face_interp_cell(mesh, rA)
    p_rgh = p_rgh.correct_boundary_conditions(mesh, phi=phi, U=U.data,
                                              rho_b=rho)
    comp = a * psi1 / rho1 + (1.0 - a) * psi2 / rho2   # [1/Pa/s scale]
    p_rgh0 = p_rgh.data
    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh, U.data)
        hf = surface.interpolate_internal(mesh, HbyA)
        phiHbyA_i = jnp.sum(mesh.sf[:nif] * hf, axis=1) \
            * mesh.face_active[:nif]
        phiHbyA = jnp.concatenate(
            [phiHbyA_i, boundary_flux(mesh, U)], axis=0)
        phig = rAf * (st_flux + buoy_flux)
        phiHbyA = phiHbyA + phig

        for nonorth in range(cfg.n_non_orth + 1):
            pEqn = fvm.laplacian(mesh, rAf, p_rgh,
                                 corrected=cfg.corrected,
                                 gamma_dims=dimTime)
            # sign: assembled laplacian row is (L p)_row with L negative
            # definite and the equation rearranged as in piso.py —
            # subtract the implicit compressibility diagonal
            comp_diag = mesh.v * comp * rdt
            src = (pEqn.source + surface.surface_sum(mesh, phiHbyA)
                   - comp_diag * p_rgh0)
            pEqn = pEqn.replace_fields(diag=pEqn.diag - comp_diag,
                                       source=src)
            pEqn, ctl_p = linear.prep_pressure(
                pEqn, False, p_ctrl, 0, 0.0)
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

    p_abs = jnp.maximum(p_rgh.data + rho * gh, cfg.p_min)
    # gas-compression rate for the next alpha step:
    # -(psi1/rho1) Dp/Dt (the a*divU part is applied separately)
    dpdt = (p_abs - p_abs_old) * rdt
    dgdt = -psi1 / jnp.maximum(rho1, 1e-6) * dpdt

    rho_new, _, _, _, _, _ = mixture_rho(cfg, a, p_abs, T.data)
    div_phi = surface.surface_sum(mesh, phi)
    cont = (rho_new - rho_old) * rdt * mesh.v + div_phi * rho_new
    diag["continuity"] = jnp.sum(jnp.abs(div_phi)) / jnp.sum(mesh.v)
    diag["p_range"] = (jnp.min(p_abs), jnp.max(p_abs))
    sum_phi = jnp.sum(jnp.abs(phi)[mesh.cface] * jnp.abs(mesh.csign),
                      axis=1)
    diag["courant_max"] = 0.5 * jnp.max(sum_phi / mesh.v) * dt

    new_state = dict(state)
    new_state.update(U=U, p_rgh=p_rgh, T=T, alpha=alpha, phi=phi,
                     rho=rho_new, p_abs=p_abs, dgdt=dgdt,
                     U0=U.data, T0=T.data)
    return new_state, diag


def initial_state(mesh, U: VolField, p_rgh: VolField, T: VolField,
                  alpha: VolField, cfg: CompIntConfig) -> Dict:
    g = jnp.asarray(cfg.g, mesh.v.dtype)
    gh = mesh.c @ g
    p_abs = jnp.maximum(p_rgh.data + 0.0 * gh, cfg.p_min)
    rho, _, _, _, _, _ = mixture_rho(cfg, alpha.data, p_abs, T.data)
    p_abs = jnp.maximum(p_rgh.data + rho * gh, cfg.p_min)
    rho, _, _, _, _, _ = mixture_rho(cfg, alpha.data, p_abs, T.data)
    return {"U": U, "p_rgh": p_rgh, "T": T, "alpha": alpha,
            "phi": fvc.flux(mesh, U), "rho": rho, "p_abs": p_abs,
            "U0": U.data, "T0": T.data,
            "dgdt": jnp.zeros(mesh.n_cells, mesh.v.dtype)}


def make_step(mesh, cfg: CompIntConfig):
    from .jitstep import jit_with_mesh

    return jit_with_mesh(
        lambda m, state, dt: compint_step(m, state, dt, cfg), mesh,
        (cfg.p_controls, cfg.u_controls))
