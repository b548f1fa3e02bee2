"""twoPhaseEulerFoam — two interpenetrating incompressible phases
(Euler-Euler) with drag coupling and a shared pressure.

Rebuild of reference: applications/solvers/multiphase/
twoPhaseEulerFoam/ (alphaEqn.H, UEqns.H, pEqn.H — the bubbleFoam
lineage; kinetic-theory granular stress and lift/virtual-mass are NOT
implemented — documented deviation, drag is the dominant closure).

Formulation (phase a = dispersed, phase b = continuous; both
incompressible, rhoa/rhob constant):

  alphaEqn: MULES-bounded  d(alpha)/dt + div(phia alpha) = 0
  UEqns:    d(Ui)/dt + div(phii, Ui) - laplacian(nuEffi, Ui)
              = -grad(p)/rhoi + g + (K/(rhoi alphai'))(Uj - Ui)
            drag implicit in the OWN phase (Sp), explicit in the other
            (partial elimination, reference: UEqns.H dragCoef).
  pEqn:     mixture continuity div(alphaf phia + betaf phib) = 0
            -> laplacian(Df, p) with Df = alphaf rAaf/rhoa
                                        + betaf rAbf/rhob

  Drag: Schiller-Naumann sphere drag
        K = 0.75 Cd rhob alpha |Ur| / d,  Cd(Re) = 24/Re (1+0.15 Re^.687)

Design: one jitted step; both phase momentum solves are standard
multi-RHS Krylov solves, alpha uses the shared MULES kernel.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.dimensions import DimensionSet, dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, mules, surface
from . import linear
from .piso import (boundary_flux, div_weights, face_interp_cell,
                   needs_reference)


class TwoPhaseConfig(NamedTuple):
    rhoa: float = 1.2          # dispersed (e.g. air)
    rhob: float = 1000.0       # continuous (e.g. water)
    nua: float = 1.5e-5
    nub: float = 1e-6
    d_a: float = 3e-3          # dispersed-phase diameter [m]
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    n_alpha_corr: int = 1
    n_correctors: int = 2
    n_non_orth: int = 0
    corrected: bool = False
    alpha_max: float = 1.0
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    u_controls: Dict = None


def drag_coefficient(cfg: TwoPhaseConfig, alpha: Any, Ua: Any, Ub: Any):
    """Schiller-Naumann K [kg/m^3/s] such that the interphase force
    density is K*(Ub - Ua) (reference: interfacialModels/dragModels/
    SchillerNaumann)."""
    Ur = Ua - Ub
    magUr = jnp.linalg.norm(Ur, axis=1)
    Re = jnp.maximum(magUr * cfg.d_a / cfg.nub, 1e-3)
    Cd = jnp.where(Re < 1000.0,
                   24.0 / Re * (1.0 + 0.15 * Re ** 0.687), 0.44)
    return 0.75 * Cd * cfg.rhob * jnp.maximum(alpha, 1e-4) * magUr / cfg.d_a


def twophase_step(mesh, state: Dict, dt: Any, cfg: TwoPhaseConfig
                  ) -> Tuple[Dict, Dict]:
    p_ctrl = cfg.p_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-8, "relTol": 0.01,
                                "maxIter": 1000}
    u_ctrl = cfg.u_controls or {"solver": "PBiCGStab", "tolerance": 1e-7,
                                "relTol": 0.0, "maxIter": 200}
    Ua: VolField = state["Ua"]
    Ub: VolField = state["Ub"]
    p: VolField = state["p"]
    alpha: VolField = state["alpha"]
    phia = state["phia"]
    phib = state["phib"]
    rdt = 1.0 / dt
    nif = mesh.n_internal_faces
    diag: Dict[str, Any] = {}
    g = jnp.asarray(cfg.g, mesh.v.dtype)

    # ---- alpha (MULES bounded advection by the dispersed-phase flux) -------
    a = alpha.data
    w_up = jnp.where(phia[:nif] >= 0, 1.0, 0.0).astype(a.dtype)
    ab = alpha.boundary_values(mesh)
    af_up = jnp.concatenate(
        [surface.interpolate_internal(mesh, a, w_up), ab], axis=0)
    phi_bd = phia * af_up * mesh.face_active
    af_lin = jnp.concatenate(
        [surface.interpolate_internal(mesh, a), ab], axis=0)
    phi_ho = phia * af_lin * mesh.face_active
    a, _ = mules.explicit_solve(mesh, a, phi_bd, phi_ho - phi_bd, dt,
                                psi_max=cfg.alpha_max, psi_min=0.0)
    alpha = alpha.with_data(a)
    beta = 1.0 - a
    diag["alpha_min"] = jnp.min(a)
    diag["alpha_max"] = jnp.max(a)

    # ---- phase momentum with partially-implicit drag -----------------------
    K = drag_coefficient(cfg, a, Ua.data, Ub.data)
    grad_p = fvc.grad_of(mesh, p, "Gauss linear")
    gcell = jnp.broadcast_to(g, (mesh.n_cells, 3))

    def phase_eqn(Uf, U0, phi_, nu_, rho_, own_frac, other_U):
        w = div_weights(mesh, phi_, "upwind", Uf)
        eqn = (fvm.ddt(mesh, Uf, U0, rdt)
               + fvm.div(mesh, phi_, Uf, weights=w)
               - fvm.laplacian(mesh, jnp.asarray(nu_, mesh.v.dtype), Uf,
                               corrected=cfg.corrected,
                               gamma_dims=dimViscosity))
        # drag/(rho_i alpha_i): implicit own velocity, explicit other
        kfac = K / (rho_ * jnp.maximum(own_frac, 1e-4))
        eqn = eqn + fvm.Sp(mesh, kfac, Uf)
        eqn = eqn.add_source(kfac[:, None] * other_U
                             - grad_p / rho_ + gcell, mesh)
        return eqn

    UaEqn = phase_eqn(Ua, state["Ua0"], phia, cfg.nua, cfg.rhoa, a,
                      Ub.data)
    UbEqn = phase_eqn(Ub, state["Ub0"], phib, cfg.nub, cfg.rhob, beta,
                      Ua.data)
    Uadata, perfa = linear.solve(mesh, UaEqn, Ua.data, u_ctrl)
    Ubdata, perfb = linear.solve(mesh, UbEqn, Ub.data, u_ctrl)
    Ua = Ua.with_data(Uadata)
    Ub = Ub.with_data(Ubdata)
    diag["Ux"] = perfa
    diag["Ubx"] = perfb

    # ---- shared pressure ----------------------------------------------------
    rAa = 1.0 / UaEqn.A(mesh)
    rAb = 1.0 / UbEqn.A(mesh)
    rAaf = face_interp_cell(mesh, rAa)
    rAbf = face_interp_cell(mesh, rAb)
    af = face_interp_cell(mesh, a)
    bf = 1.0 - af

    HbyAa = rAa[:, None] * UaEqn.H(mesh, Ua.data)
    HbyAb = rAb[:, None] * UbEqn.H(mesh, Ub.data)
    # re-add the explicit grad(p) used in H by removing it: H contains
    # the full source incl. -grad(p)/rho; subtract it back out so the
    # pressure enters ONLY through the new solve
    HbyAa = HbyAa + rAa[:, None] * grad_p / cfg.rhoa
    HbyAb = HbyAb + rAb[:, None] * grad_p / cfg.rhob

    def face_flux(H, Uf):
        # boundary part from the BC velocity (walls seal the box) —
        # owner extrapolation would let a uniform body-force fall look
        # divergence-free and the pressure would never oppose gravity
        hf = surface.interpolate_internal(mesh, H)
        fi = jnp.sum(mesh.sf[:nif] * hf, axis=1) * mesh.face_active[:nif]
        return jnp.concatenate([fi, boundary_flux(mesh, Uf)], axis=0)

    phiHbyAa = face_flux(HbyAa, Ua)
    phiHbyAb = face_flux(HbyAb, Ub)
    phiHbyA = af * phiHbyAa + bf * phiHbyAb
    Df = af * rAaf / cfg.rhoa + bf * rAbf / cfg.rhob

    for nonorth in range(cfg.n_non_orth + 1):
        pEqn = fvm.laplacian(mesh, Df, p, corrected=cfg.corrected,
                             gamma_dims=dimTime *
                             DimensionSet.of(-1, 3, 0))
        pEqn = pEqn.replace_fields(
            source=pEqn.source + surface.surface_sum(mesh, phiHbyA))
        pEqn, ctl_p = linear.prep_pressure(
            pEqn, needs_reference(p, mesh), p_ctrl,
            cfg.p_ref_cell, cfg.p_ref_value)
        pdata, pperf = linear.solve(mesh, pEqn, p.data, ctl_p)
        p = p.with_data(pdata)
        if nonorth == 0:
            diag["p_initial"] = pperf.initial_residual
            diag["p_iters"] = pperf.n_iterations
        diag["p_final"] = pperf.final_residual

    pflux = pEqn.flux(mesh, p.data)
    phi_mix = phiHbyA - pflux
    # distribute the correction to the phase fluxes in proportion to
    # their mobility (reference: pEqn.H phia/phib corrections)
    denom = jnp.maximum(Df, 1e-30)
    corr_face = pflux / denom
    phia = phiHbyAa - (rAaf / cfg.rhoa) * corr_face
    phib = phiHbyAb - (rAbf / cfg.rhob) * corr_face
    gp_new = fvc.grad_of(mesh, p, "Gauss linear")
    Ua = Ua.with_data(HbyAa - rAa[:, None] * gp_new / cfg.rhoa)
    Ub = Ub.with_data(HbyAb - rAb[:, None] * gp_new / cfg.rhob)
    Ua = Ua.correct_boundary_conditions(mesh, phi=phia)
    Ub = Ub.correct_boundary_conditions(mesh, phi=phib)

    div_mix = surface.surface_sum(mesh, phi_mix)
    diag["continuity"] = jnp.sum(jnp.abs(div_mix)) / jnp.sum(mesh.v)
    sum_phi = jnp.sum(jnp.abs(phi_mix)[mesh.cface] * jnp.abs(mesh.csign),
                      axis=1)
    diag["courant_max"] = 0.5 * jnp.max(sum_phi / mesh.v) * dt

    new_state = dict(state)
    new_state.update(Ua=Ua, Ub=Ub, p=p, alpha=alpha, phia=phia,
                     phib=phib, Ua0=Ua.data, Ub0=Ub.data)
    return new_state, diag


def initial_state(mesh, Ua: VolField, Ub: VolField, p: VolField,
                  alpha: VolField) -> Dict:
    return {"Ua": Ua, "Ub": Ub, "p": p, "alpha": alpha,
            "phia": fvc.flux(mesh, Ua), "phib": fvc.flux(mesh, Ub),
            "Ua0": Ua.data, "Ub0": Ub.data}


def make_step(mesh, cfg: TwoPhaseConfig):
    from .jitstep import jit_with_mesh

    return jit_with_mesh(
        lambda m, state, dt: twophase_step(m, state, dt, cfg), mesh,
        (cfg.p_controls, cfg.u_controls))
