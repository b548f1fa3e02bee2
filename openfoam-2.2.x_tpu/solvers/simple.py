"""simpleFoam — steady-state incompressible SIMPLE solver.

Reference: applications/solvers/incompressible/simpleFoam/
(simpleFoam.C, UEqn.H, pEqn.H) + simpleControl
(src/finiteVolume/cfdTools/general/solutionControl/). One SIMPLE outer
iteration = one "time step"; under-relaxation on U (implicit, matrix
relax) and p (explicit); turbulence corrected each iteration;
convergence by residualControl.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..bc import patchfields as pf
from ..core.dimensions import dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, surface
from . import linear
from .piso import (boundary_flux, div_weights, face_interp_cell,
                   needs_reference)


class SimpleConfig(NamedTuple):
    nu: float
    n_non_orth: int = 0
    corrected: bool = False
    corr_limit: float = 1.0
    div_scheme: str = "linear"
    grad_scheme: str = "Gauss linear"  # for grad(p)
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    alpha_u: float = 0.7
    alpha_p: float = 0.3
    p_controls: Dict = None
    u_controls: Dict = None
    turb: Any = None
    turb_controls: Dict = None
    turb_relax: float = 0.7
    fv_options: Any = None   # models/fvoptions.OptionList
    mrf: Any = None          # models/mrf.MRFZones


def adjust_phi(mesh, phi_b: Any, U: VolField) -> Any:
    """Global flux balance over adjustable boundaries
    (reference: cfdTools/general/adjustPhi/adjustPhi.C): scale the
    outflow on non-fixed-value patches so net boundary flux vanishes
    (required for a solvable all-Neumann pressure equation)."""
    nif = mesh.n_internal_faces
    adjustable = []
    for patch, bc in zip(mesh.patches, U.bcs):
        fixed = pf.is_value_bc(bc) or bc.kind in ("empty", "symmetry",
                                                  "symmetryPlane", "slip")
        adjustable.append(
            jnp.full((patch.size,), 0.0 if fixed else 1.0, mesh.v.dtype)
        )
    adj = jnp.concatenate(adjustable) if adjustable else jnp.zeros(0)
    fixed_flux = jnp.sum(phi_b * (1.0 - adj))
    out = jnp.sum(jnp.maximum(phi_b, 0.0) * adj)
    inn = jnp.sum(jnp.minimum(phi_b, 0.0) * adj)
    mass_in = -(fixed_flux + inn)
    scale = mass_in / jnp.where(jnp.abs(out) > 1e-30, out, 1.0)
    scale = jnp.where(jnp.abs(out) > 1e-30, scale, 1.0)
    return jnp.where((phi_b > 0) & (adj > 0), phi_b * scale, phi_b)


def simple_step(mesh, state: Dict, cfg: SimpleConfig) -> Tuple[Dict, Dict]:
    """One SIMPLE outer iteration."""
    p_ctrl = cfg.p_controls or {"solver": "PCG", "tolerance": 1e-6,
                                "relTol": 0.01}
    u_ctrl = cfg.u_controls or {"solver": "smoothSolver", "tolerance": 1e-5,
                                "relTol": 0.1, "maxIter": 200, "nSweeps": 2}
    from ..ops import schemes as schemes_mod
    from ..ops import slot as slot_mod

    U: VolField = state["U"]
    p: VolField = state["p"]
    phi = state["phi"]
    nif = mesh.n_internal_faces
    diag: Dict[str, Any] = {}
    dt = jnp.asarray(1.0, mesh.v.dtype)  # pseudo-time for turb ddt (steady)

    if "phi_slot" in state:
        phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    else:
        phi_slot = slot_mod.from_flat(mesh, phi)

    # -- momentum predictor with under-relaxation ------------------------------
    w_slot = (None if cfg.div_scheme == "linear" else
              schemes_mod.weights_slot(mesh, phi_slot, cfg.div_scheme, U))
    UEqn = fvm.div(mesh, phi, U, phi_slot=phi_slot, slot_weights=w_slot)
    if cfg.turb is not None:
        visc_mat, visc_expl = cfg.turb.div_dev_reff(mesh, state["turb"], U)
        UEqn = UEqn + visc_mat
        UEqn = UEqn.add_source(-visc_expl, mesh)
    else:
        UEqn = UEqn - fvm.laplacian(
            mesh, jnp.asarray(cfg.nu, mesh.v.dtype), U,
            corrected=cfg.corrected, gamma_dims=dimViscosity,
            limit=cfg.corr_limit)
    if cfg.fv_options:
        UEqn = cfg.fv_options.add_to(mesh, UEqn, "U", U, U=U,
                                     fvopt_state=state.get("fvopt"))
    if cfg.mrf:
        # reference: mrfZones.addCoriolis(UEqn()) — BEFORE relax so the
        # H/A split sees the rotating-frame source
        UEqn = cfg.mrf.add_coriolis(mesh, UEqn, U)
    if "alpha_sink" in state:
        # adjointShapeOptimizationFoam porosity design variable
        # (reference: its UEqn.H `fvm::Sp(alpha, U)`)
        UEqn = UEqn + fvm.Sp(mesh, state["alpha_sink"], U)
    UEqn = UEqn.relax(mesh, cfg.alpha_u, U.data)
    grad_p = fvc.grad_of(mesh, p, cfg.grad_scheme)
    Umat = UEqn.add_source(-grad_p, mesh)
    Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
    U = U.with_data(Udata)
    diag["Ux"] = uperf

    # -- pressure correction -------------------------------------------------------
    rA = 1.0 / UEqn.A(mesh)
    HbyA = rA[:, None] * UEqn.H(mesh, U.data)
    phiHbyA = slot_mod.flux_of(mesh, HbyA, bv=boundary_flux(mesh, U))
    if cfg.mrf:
        # reference: mrfZones.relativeFlux(phiHbyA) before adjustPhi
        phiHbyA = cfg.mrf.make_relative(mesh, phiHbyA)
    phiHbyA_b = phiHbyA.bv
    closed = needs_reference(p, mesh)
    if closed:
        phiHbyA_b = adjust_phi(mesh, phiHbyA_b, U)
        phiHbyA = phiHbyA._replace(bv=phiHbyA_b)
    rA_b = surface.owner_to_b(mesh, rA)
    rAf_slot = slot_mod.interpolate(mesh, rA, bv=rA_b)
    rAf = slot_mod.to_flat(mesh, rAf_slot)

    p_old = p.data
    # constant pressure-matrix coefficients across non-ortho iterations:
    # assemble once, share one GAMG prep (see piso_step)
    use_corr = cfg.corrected and not getattr(mesh, "orthogonal", False)
    pEqn0 = fvm.laplacian(mesh, rAf, p, corrected=cfg.corrected,
                          gamma_dims=dimTime, limit=cfg.corr_limit,
                          defer_correction=True, gamma_slot=rAf_slot)
    p_ctrl_p = linear.prepare_controls(mesh, pEqn0, p_ctrl)
    for nonorth in range(cfg.n_non_orth + 1):
        corr_face = None
        if use_corr:
            corr_face, corr_cell = slot_mod.laplacian_correction(
                mesh, rAf_slot, p.data, p.boundary_values(mesh),
                limit=cfg.corr_limit)
            pEqn = pEqn0.replace_fields(
                source=pEqn0.source - corr_cell
                + slot_mod.surface_sum(mesh, phiHbyA))
        else:
            pEqn = pEqn0.replace_fields(
                source=pEqn0.source + slot_mod.surface_sum(mesh, phiHbyA))
        pEqn, ctl_p = linear.prep_pressure(
            pEqn, closed, p_ctrl_p, cfg.p_ref_cell, cfg.p_ref_value)
        pdata, pperf = linear.solve(mesh, pEqn, p.data, ctl_p)
        p = p.with_data(pdata)
        if nonorth == 0:
            diag["p_initial"] = pperf.initial_residual
            diag["p_iters"] = pperf.n_iterations
        diag["p_final"] = pperf.final_residual
        if nonorth == cfg.n_non_orth:
            F = slot_mod.laplacian_flux(mesh, rAf_slot, p.data,
                                        corrected=use_corr, corr=corr_face)
            p_bc = surface.owner_to_b(mesh, p.data)
            F_b = pEqn.ic * p_bc - pEqn.bc
            phi_slot = slot_mod.SlotFace(
                phiHbyA.sv - F.sv, phiHbyA.fb - F.fb, phiHbyA_b - F_b)

    # explicit pressure relaxation AFTER the flux correction (reference:
    # pEqn.H: p.relax() after phi update keeps the flux conservative)
    p = p.with_data(p_old + cfg.alpha_p * (p.data - p_old))
    grad_p = fvc.grad_of(mesh, p, cfg.grad_scheme)
    U = U.with_data(HbyA - rA[:, None] * grad_p)
    phi = slot_mod.to_flat(mesh, phi_slot)
    phi_for_bc = jnp.concatenate(
        [jnp.zeros(nif, phi.dtype), phi_slot.bv], axis=0)
    U = U.correct_boundary_conditions(mesh, phi=phi_for_bc)
    fvopt_state = state.get("fvopt")
    if cfg.fv_options:
        # reference: fvOptions.correct(U) after the corrector loop
        U, fvopt_state = cfg.fv_options.correct_U(mesh, U, rA, fvopt_state)

    # -- turbulence -------------------------------------------------------------
    new_turb = state.get("turb")
    if cfg.turb is not None:
        new_turb, tdiag = cfg.turb.correct(
            mesh, state["turb"], U, phi, dt, steady=True,
            relax=cfg.turb_relax, controls=cfg.turb_controls,
            phi_slot=phi_slot)
        diag.update({f"turb_{k}": v for k, v in tdiag.items()})

    div_phi = slot_mod.surface_sum(mesh, phi_slot)
    diag["continuity"] = jnp.sum(jnp.abs(div_phi)) / jnp.sum(mesh.v)
    diag["continuity_global"] = jnp.sum(div_phi) / jnp.sum(mesh.v)

    new_state = dict(state)
    new_state.update(U=U, p=p, phi=phi,
                     phi_slot=(phi_slot.sv, phi_slot.fb))
    if fvopt_state is not None:
        new_state["fvopt"] = fvopt_state
    if new_turb is not None:
        new_state["turb"] = new_turb
    return new_state, diag


def make_step(mesh, cfg: SimpleConfig):
    from .jitstep import jit_with_mesh

    return jit_with_mesh(
        lambda m, state: simple_step(m, state, cfg), mesh,
        (cfg.p_controls, cfg.u_controls))


def make_chunk(mesh, cfg: SimpleConfig, n: int):
    """n SIMPLE iterations per device call (lax.scan) — one host
    round-trip and one program launch per chunk instead of per
    iteration."""
    from .jitstep import jit_with_mesh

    def chunk(m, state):
        def body(st, _):
            st, diag = simple_step(m, st, cfg)
            return st, diag

        state_out, diags = jax.lax.scan(body, state, None, length=n)
        # return the last iteration's diagnostics
        last = jax.tree_util.tree_map(lambda x: x[-1], diags)
        return state_out, last

    return jit_with_mesh(chunk, mesh, (cfg.p_controls, cfg.u_controls))


def converged(diag: Dict, residual_control: Dict) -> bool:
    """simpleControl residualControl check (host-side, on initial
    residuals — reference: solutionControl::criteriaSatisfied)."""
    import numpy as np

    if not residual_control:
        return False
    for name, tol in residual_control.items():
        if name in ("p",):
            r = float(np.max(np.asarray(diag.get("p_initial", 1.0))))
        elif name in ("U", "Ux"):
            perf = diag.get("Ux")
            r = float(np.max(np.asarray(perf.initial_residual))) if perf else 1.0
        else:
            perf = diag.get(f"turb_{name}")
            r = float(np.max(np.asarray(perf.initial_residual))) if perf else 1.0
        if r > float(tol):
            return False
    return True
