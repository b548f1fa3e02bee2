"""adjointShapeOptimizationFoam — continuous-adjoint topology
optimization for power dissipation.

Rebuild of reference: applications/solvers/incompressible/
adjointShapeOptimizationFoam/ (primal SIMPLE with a porosity sink
alpha*U; adjoint momentum

    UaEqn: div(-phi, Ua) - (grad(Ua) . U)  - laplacian(nu, Ua)
           + Sp(alpha, Ua) == -grad(pa)

with (grad Ua).U the adjointTransposeConvection term; adjoint
continuity via the same SIMPLE pressure projection; and the porosity
update

    alpha <- alpha + relax * (lambda * max(Ua & U, 0) - alpha)

clipped to [0, alphaMax], with alpha frozen at zero in the inlet
cells (reference: zeroCells(alpha, inletCells)).

Simplified adjoint BCs (documented deviation): Ua = -U_bc on value
patches, zeroGradient elsewhere; pa zeroGradient except fixedValue 0
where p is value-fixed — the reference's adjointOutletVelocity/
Pressure BCs linearise the same conditions.

Design: the primal and adjoint SIMPLE iterations run as ONE jitted
program per optimization sweep — the adjoint matrix reuses the primal
assembly machinery with the flux sign flipped.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.dimensions import dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, slot as slot_mod, surface
from . import linear
from .piso import boundary_flux, needs_reference
from .simple import SimpleConfig, simple_step


class AdjointConfig(NamedTuple):
    flow: SimpleConfig
    lam: float = 1e5              # sensitivity scale lambda
    alpha_max: float = 200.0
    alpha_relax: float = 0.1
    zero_alpha_cells: Any = None  # int32 cell ids kept at alpha = 0


def _primal_with_alpha(mesh, state, cfg: AdjointConfig):
    """One primal SIMPLE iteration including the alpha*U porosity sink
    (reference: UEqn.H `fvm::Sp(alpha, U)`)."""
    f = cfg.flow
    st = dict(state)
    st["alpha_sink"] = state["alpha"]   # simple_step adds Sp(alpha, U)
    st, diag = simple_step(mesh, st, f)
    return st, diag


def adjoint_step(mesh, state: Dict, cfg: AdjointConfig
                 ) -> Tuple[Dict, Dict]:
    """One optimization sweep: primal SIMPLE + adjoint SIMPLE + alpha
    update."""
    f = cfg.flow
    p_ctrl = f.p_controls or {"solver": "PCG", "tolerance": 1e-6,
                              "relTol": 0.01}
    u_ctrl = f.u_controls or {"solver": "PBiCGStab",
                              "tolerance": 1e-6, "relTol": 0.1,
                              "maxIter": 200}
    state, diag = _primal_with_alpha(mesh, state, cfg)
    U: VolField = state["U"]
    phi = state["phi"]
    alpha = state["alpha"]
    Ua: VolField = state["Ua"]
    pa: VolField = state["pa"]
    nif = mesh.n_internal_faces

    # ---- adjoint momentum -----------------------------------------------------
    phi_slot = slot_mod.from_flat(mesh, phi)
    neg_phi = -phi
    neg_slot = slot_mod.SlotFace(-phi_slot.sv, -phi_slot.fb,
                                 -phi_slot.bv)
    UaEqn = (fvm.div(mesh, neg_phi, Ua, phi_slot=neg_slot)
             - fvm.laplacian(mesh, jnp.asarray(f.nu, mesh.v.dtype),
                             Ua, corrected=f.corrected,
                             gamma_dims=dimViscosity)
             + fvm.Sp(mesh, alpha, Ua))
    # adjointTransposeConvection: (grad(Ua) & U)_i = d_i Ua_j * U_j
    # (fvc.grad on a vector field returns g[c,i,j] = d_i u_j)
    gUa = fvc.grad(mesh, Ua)                      # [nC, i, j]
    atc = jnp.einsum("cij,cj->ci", gUa, U.data)
    UaEqn = UaEqn.relax(mesh, f.alpha_u, Ua.data)
    grad_pa = fvc.grad_of(mesh, pa, f.grad_scheme)
    Uamat = UaEqn.add_source(-grad_pa - atc, mesh)
    Uadata, uaperf = linear.solve(mesh, Uamat, Ua.data, u_ctrl)
    Ua = Ua.with_data(Uadata)
    diag["Uax"] = uaperf

    # ---- adjoint pressure projection -------------------------------------------
    rA = 1.0 / UaEqn.A(mesh)
    HbyA = rA[:, None] * UaEqn.H(mesh, Ua.data)
    phiHbyA = slot_mod.flux_of(mesh, HbyA, bv=boundary_flux(mesh, Ua))
    rAf_slot = slot_mod.interpolate(mesh, rA,
                                    bv=surface.owner_to_b(mesh, rA))
    rAf = slot_mod.to_flat(mesh, rAf_slot)
    paEqn = fvm.laplacian(mesh, rAf, pa, corrected=f.corrected,
                          gamma_dims=dimTime, gamma_slot=rAf_slot)
    paEqn = paEqn.replace_fields(
        source=paEqn.source + slot_mod.surface_sum(mesh, phiHbyA))
    paEqn, ctl = linear.prep_pressure(paEqn, needs_reference(pa, mesh),
                                      p_ctrl, f.p_ref_cell, 0.0)
    padata, paperf = linear.solve(mesh, paEqn, pa.data, ctl)
    pa_old = pa.data
    pa = pa.with_data(pa_old + f.alpha_p * (padata - pa_old))
    diag["pa_initial"] = paperf.initial_residual
    grad_pa = fvc.grad_of(mesh, pa, f.grad_scheme)
    Ua = Ua.with_data(HbyA - rA[:, None] * grad_pa)
    Ua = Ua.correct_boundary_conditions(mesh)

    # ---- porosity (design variable) update -------------------------------------
    sens = jnp.sum(Ua.data * U.data, axis=1)      # Ua & U
    target = cfg.lam * jnp.maximum(sens, 0.0)
    alpha_new = alpha + cfg.alpha_relax * (target - alpha)
    alpha_new = jnp.clip(alpha_new, 0.0, cfg.alpha_max)
    if cfg.zero_alpha_cells is not None:
        alpha_new = alpha_new.at[cfg.zero_alpha_cells].set(0.0)
    diag["alpha_max_val"] = jnp.max(alpha_new)
    # objective: total power dissipation ~ sum(alpha U^2 + nu |grad U|^2)
    gU = fvc.grad(mesh, U)
    diag["objective"] = jnp.sum(
        (alpha_new * jnp.sum(U.data ** 2, axis=1)
         + f.nu * jnp.sum(gU ** 2, axis=(1, 2))) * mesh.v)

    new_state = dict(state)
    new_state.update(Ua=Ua, pa=pa, alpha=alpha_new)
    return new_state, diag


def initial_state(mesh, U: VolField, p: VolField, Ua: VolField,
                  pa: VolField, cfg: AdjointConfig) -> Dict:
    st = {"U": U, "p": p, "phi": fvc.flux(mesh, U), "Ua": Ua,
          "pa": pa, "alpha": jnp.zeros(mesh.n_cells, mesh.v.dtype)}
    return st


def make_step(mesh, cfg: AdjointConfig):
    return jax.jit(lambda state: adjoint_step(mesh, state, cfg))
