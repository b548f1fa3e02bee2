"""settlingFoam — drift-flux mixture model for settling suspensions.

Rebuild of reference: applications/solvers/multiphase/settlingFoam/
(alphaEqn.H with the relative (drift) flux phiVdj, UEqn.H on the
mixture, calcVdj.H with the `simple` and `general` hindered-settling
laws, plastic/BinghamPlastic viscosity of the continuous phase).

Mixture formulation — alpha is the dispersed-phase MASS fraction
(reference convention):
    rho   = 1 / (alpha/rhod + (1-alpha)/rhoc)
    Vdj   : simple : V0 * 10^(-a * max(alpha - alphaMin, 0))
            general: V0 * (exp(-a*(alpha-alphaMin)) - exp(-a1*(alpha-alphaMin)))
    alphaEqn: ddt(rho,alpha) + div(phi,alpha) + div(phiVdj alpha_f)
              = laplacian(mut/Sc, alpha)
    UEqn  : mixture momentum with the drift stress div(Vdj Vdj rho
            alpha) folded into the buoyancy treatment (p_rgh form).

Design: flat-face interFoam-style assembly; the drift flux is one
extra elementwise face term. Turbulent Schmidt diffusion uses the
molecular + plastic viscosity (no k-eps mixture model here —
documented deviation; the plastic viscosity carries the hindered
rheology)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.dimensions import DimensionSet, dimDensity, dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, surface
from . import linear
from .piso import (boundary_flux, div_weights, face_interp_cell,
                   needs_reference)


class SettlingConfig(NamedTuple):
    rhoc: float = 1000.0          # continuous phase density
    rhod: float = 1042.0          # dispersed phase density
    muc: float = 1e-3             # continuous dynamic viscosity
    # plastic viscosity law (reference: plasticViscosity.H):
    # mu_pl = plasticViscosityCoeff * (10^(plasticViscosityExponent
    #         * alpha) - 1)
    plastic_coeff: float = 0.0
    plastic_exp: float = 0.0
    # drift velocity (reference: calcVdj.H)
    vdj_model: str = "simple"     # or "general"
    V0: Tuple[float, float, float] = (0.0, -0.002, 0.0)
    a: float = 8.84
    a1: float = 0.0
    alpha_min: float = 0.0
    Sc: float = 1.0               # Schmidt number for alpha diffusion
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    n_correctors: int = 2
    n_non_orth: int = 0
    corrected: bool = False
    momentum_predictor: bool = True
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    u_controls: Dict = None


def mixture_rho(cfg: SettlingConfig, alpha):
    a = jnp.clip(alpha, 0.0, 1.0)
    return 1.0 / (a / cfg.rhod + (1.0 - a) / cfg.rhoc)


def vdj(cfg: SettlingConfig, alpha):
    """Hindered settling drift velocity [nC,3]."""
    a = jnp.maximum(alpha - cfg.alpha_min, 0.0)
    V0 = jnp.asarray(cfg.V0, alpha.dtype)
    if cfg.vdj_model == "general":
        f = jnp.exp(-cfg.a * a) - jnp.exp(-cfg.a1 * a)
    else:
        f = 10.0 ** (-cfg.a * a)
    return V0[None, :] * f[:, None]


def mu_mixture(cfg: SettlingConfig, alpha):
    mu_pl = cfg.plastic_coeff * (10.0 ** (cfg.plastic_exp
                                          * jnp.clip(alpha, 0.0, 1.0))
                                 - 1.0)
    return cfg.muc + mu_pl


def settling_step(mesh, state: Dict, dt: Any, cfg: SettlingConfig
                  ) -> Tuple[Dict, Dict]:
    p_ctrl = cfg.p_controls or {"solver": "PCG", "tolerance": 1e-7,
                                "relTol": 0.05}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab",
                                "tolerance": 1e-7, "relTol": 0.0,
                                "maxIter": 200}
    U: VolField = state["U"]
    p_rgh: VolField = state["p_rgh"]
    alpha: VolField = state["alpha"]
    phi = state["phi"]            # volumetric mixture flux
    rho_old = state["rho"]
    rdt = 1.0 / dt
    nif = mesh.n_internal_faces
    diag: Dict[str, Any] = {}

    g = jnp.asarray(cfg.g, mesh.v.dtype)
    ghf = mesh.cf @ g

    # ---- drift flux (reference: calcVdj.H + compressionFlux) -----------------
    Vdj_c = vdj(cfg, alpha.data)
    vf = surface.interpolate_internal(mesh, Vdj_c)
    phiVdj_i = jnp.sum(mesh.sf[:nif] * vf, axis=1) \
        * mesh.face_active[:nif]
    # walls: no drift through boundaries
    phiVdj = jnp.concatenate(
        [phiVdj_i, jnp.zeros(mesh.n_faces - nif, mesh.v.dtype)], axis=0)

    # ---- alphaEqn: bounded upwind on (phi + phiVdj) + diffusion ---------------
    a = alpha.data
    phi_tot = phi + phiVdj
    w_up = jnp.where(phi_tot[:nif] >= 0, 1.0, 0.0).astype(a.dtype)
    af_i = surface.interpolate_internal(mesh, a, w_up)
    ab = alpha.boundary_values(mesh)
    af = jnp.concatenate([af_i, ab], axis=0)
    adv = surface.surface_sum(mesh, phi_tot * af * mesh.face_active)
    mu = mu_mixture(cfg, a)
    D_f = face_interp_cell(mesh, mu / cfg.Sc / mixture_rho(cfg, a))
    diff = surface.surface_sum(
        mesh, D_f * fvc.sn_grad(mesh, alpha) * mesh.mag_sf
        * mesh.face_active)
    a_new = jnp.clip(a + dt * (-adv + diff) / mesh.v, 0.0, 1.0)
    alpha = alpha.with_data(a_new)
    rho = mixture_rho(cfg, alpha.data)
    mu = mu_mixture(cfg, alpha.data)
    diag["alpha_range"] = (jnp.min(a_new), jnp.max(a_new))
    diag["alpha_mass"] = jnp.sum(rho * a_new * mesh.v)

    # ---- mixture momentum ------------------------------------------------------
    rho_f = face_interp_cell(mesh, rho)
    rho_phi = phi * rho_f
    mu_f = face_interp_cell(mesh, mu)
    w_div = div_weights(mesh, rho_phi, "upwind", U)
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
    from ..bc.patchfields import default_bcs

    sng_rho = fvc.sn_grad(mesh, VolField(
        data=rho, bcs=default_bcs(mesh, rank=0), name="rho",
        dims=dimDensity))
    buoy_flux = -ghf * sng_rho * mesh.mag_sf * mesh.face_active
    grad_prgh = fvc.grad(mesh, p_rgh)
    if cfg.momentum_predictor:
        rhs_cell = fvc.reconstruct(mesh, buoy_flux) - grad_prgh
        Udata, uperf = linear.solve(
            mesh, UEqn.add_source(rhs_cell, mesh), U.data, u_ctrl)
        U = U.with_data(Udata)
        diag["Ux"] = uperf

    # ---- PISO on p_rgh --------------------------------------------------------
    rA = 1.0 / UEqn.A(mesh)
    rAf = face_interp_cell(mesh, rA)
    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh, U.data)
        hf = surface.interpolate_internal(mesh, HbyA)
        phiHbyA_i = jnp.sum(mesh.sf[:nif] * hf, axis=1) \
            * mesh.face_active[:nif]
        phiHbyA = jnp.concatenate([phiHbyA_i, boundary_flux(mesh, U)],
                                  axis=0)
        phig = rAf * buoy_flux
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
            diag["p_final"] = pperf.final_residual
            if nonorth == cfg.n_non_orth:
                phi = phiHbyA - pEqn.flux(mesh, p_rgh.data)
        pflux = pEqn.flux(mesh, p_rgh.data)
        U = U.with_data(HbyA + rA[:, None] * fvc.reconstruct(
            mesh, (phig - pflux) / jnp.maximum(rAf, 1e-30)))
        U = U.correct_boundary_conditions(mesh, phi=phi)

    div_phi = surface.surface_sum(mesh, phi)
    diag["continuity"] = jnp.sum(jnp.abs(div_phi)) / jnp.sum(mesh.v)

    new_state = dict(state)
    new_state.update(U=U, p_rgh=p_rgh, alpha=alpha, phi=phi, rho=rho,
                     U0=U.data)
    return new_state, diag


def initial_state(mesh, U: VolField, p_rgh: VolField, alpha: VolField,
                  cfg: SettlingConfig) -> Dict:
    return {"U": U, "p_rgh": p_rgh, "alpha": alpha,
            "phi": fvc.flux(mesh, U),
            "rho": mixture_rho(cfg, alpha.data), "U0": U.data}


def make_step(mesh, cfg: SettlingConfig):
    return jax.jit(lambda state, dt: settling_step(mesh, state, dt,
                                                   cfg))
