"""solidDisplacementFoam / solidEquilibriumDisplacementFoam — linear
elastic (small-strain) stress analysis.

Rebuild of reference: applications/solvers/stressAnalysis/
{solidDisplacementFoam,solidEquilibriumDisplacementFoam}/
(solidDisplacementFoam.C, DEqn.H, tractionDisplacement BC). The
segregated displacement formulation:

    DEqn: fvm::d2dt2(D) == fvm::laplacian(2*mu + lambda, D)
                          + fvc::div(sigmaExp)
    sigmaExp = mu*gradD.T + lambda*I*tr(gradD) - (mu+lambda)*gradD

iterated (inner corrector loop) until the initial residual falls under
convergenceTolerance — the explicit cross-derivative coupling converges
by fixed point. Traction BCs (tractionDisplacement) are fixedGradient
BCs whose gradient is recomputed each inner iteration:

    g = (traction - pressure*n - n.sigmaExp) / (2*mu + lambda)

Lamé constants from mechanicalProperties (E, nu, rho; planeStress
switch rescales lambda). Thermal stress (thermalStress on) adds the
-threeKalpha*grad(T) coupling — not yet implemented (raises).

Design: the whole inner loop is unrolled in ONE jitted step;
sigmaExp face interpolation runs on flat gather ops (cold path, one
tensor interpolation per iteration)."""

from __future__ import annotations

import dataclasses as _dc
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..bc import patchfields as pf
from ..core.dimensions import DimensionSet
from ..core.fields import VolField
from ..ops import fvc, fvm, surface
from . import linear


class SolidConfig(NamedTuple):
    rho: float                  # density [kg/m3]
    E: float                    # Young's modulus [Pa]
    nu: float                   # Poisson ratio
    plane_stress: bool = False
    steady: bool = False        # solidEquilibriumDisplacementFoam
    n_corr: int = 30            # max inner iterations per step
    tolerance: float = 1e-6     # convergenceTolerance on initial resid
    compact_traction: bool = False
    d_controls: Dict = None
    traction: Tuple = ()        # per-patch (traction[3], pressure) or None


def lame(cfg: SolidConfig) -> Tuple[float, float]:
    """(mu, lambda) per unit density as the reference solves
    (D-equation divided by rho): mu = E/(2(1+nu))/rho etc."""
    E, nu = cfg.E, cfg.nu
    mu = E / (2.0 * (1.0 + nu))
    lam = nu * E / ((1.0 + nu) * (1.0 - 2.0 * nu))
    if cfg.plane_stress:
        lam = nu * E / ((1.0 + nu) * (1.0 - nu))
    return mu / cfg.rho, lam / cfg.rho


def _sigma_exp(mesh, gradD, mu, lam):
    """sigmaExp[c,i,j] = mu dD_i/dx_j + lam delta_ij tr - (mu+lam) dD_j/dx_i
    with gradD[c,i,j] = dD_j/dx_i (fvc.grad convention)."""
    I3 = jnp.eye(3, dtype=gradD.dtype)
    tr = jnp.trace(gradD, axis1=1, axis2=2)
    return (mu * jnp.swapaxes(gradD, 1, 2)
            + lam * tr[:, None, None] * I3[None]
            - (mu + lam) * gradD)


def _div_tensor(mesh, T):
    """fvc::div of a [nC,3,3] tensor: per-cell Gauss sum of Sf_i T_ij
    (zero-gradient boundary extrapolation)."""
    nC = T.shape[0]
    nif = mesh.n_internal_faces
    Tf_i = surface.interpolate_internal(mesh, T.reshape(nC, 9))
    Tf_b = surface.owner_to_b(mesh, T.reshape(nC, 9))
    Tf = jnp.concatenate([Tf_i, Tf_b], axis=0).reshape(-1, 3, 3)
    Ff = jnp.einsum("fi,fij->fj", mesh.sf, Tf)
    Ff = Ff * mesh.face_active[:, None]
    return fvc.surface_integrate(mesh, Ff)


def _update_traction_bcs(mesh, D: VolField, gradD, mu, lam,
                         cfg: SolidConfig) -> VolField:
    """Recompute fixedGradient values on traction patches (reference:
    tractionDisplacementFvPatchVectorField::updateCoeffs)."""
    if not any(t is not None for t in cfg.traction):
        return D
    nif = mesh.n_internal_faces
    sig = _sigma_exp(mesh, gradD, mu, lam)
    bcs = list(D.bcs)
    for ip, (patch, trac) in enumerate(zip(mesh.patches, cfg.traction)):
        if trac is None:
            continue
        sl = patch.slice
        n = mesh.sf[sl] / jnp.maximum(mesh.mag_sf[sl], 1e-30)[:, None]
        tvec = jnp.broadcast_to(jnp.asarray(trac[0], mesh.v.dtype),
                                n.shape)
        pres = jnp.asarray(trac[1], mesh.v.dtype)
        pres = (pres[:, None] if jnp.ndim(pres) == 1 else pres)
        sig_b = sig[mesh.owner[sl]]
        nsig = jnp.einsum("fi,fij->fj", n, sig_b)
        g = (tvec - pres * n - nsig) / (2.0 * mu + lam)
        bcs[ip] = bcs[ip].replace(ref_grad=g)
    return _dc.replace(D, bcs=tuple(bcs))


def solid_step(mesh, state: Dict, dt: Any, cfg: SolidConfig
               ) -> Tuple[Dict, Dict]:
    """One time step (transient) or one outer block (steady): inner
    corrector iterations of the segregated D equation."""
    d_ctrl = cfg.d_controls or {"solver": "PCG",
                                "preconditioner": "polynomial",
                                "tolerance": 1e-9, "relTol": 0.01,
                                "maxIter": 1000}
    D: VolField = state["D"]
    rdt = 1.0 / dt
    mu, lam = lame(cfg)
    gamma = jnp.asarray(2.0 * mu + lam, mesh.v.dtype)
    diag: Dict[str, Any] = {}
    D0 = state.get("D0", D.data)
    D00 = state.get("D00", D0)

    init_res = None
    for it in range(cfg.n_corr):
        gradD = fvc.grad(mesh, D)
        D = _update_traction_bcs(mesh, D, gradD, mu, lam, cfg)
        if any(t is not None for t in cfg.traction):
            gradD = fvc.grad(mesh, D)  # with updated BC gradients
        sig_exp = _sigma_exp(mesh, gradD, mu, lam)
        div_sig = _div_tensor(mesh, sig_exp)
        lap = fvm.laplacian(
            mesh, jnp.asarray(gamma, mesh.v.dtype), D, corrected=False,
            gamma_dims=DimensionSet.of(0, 2, -2))
        if cfg.steady:
            DEqn = -lap
        else:
            DEqn = fvm.d2dt2(mesh, D, D0, D00, rdt) - lap
        DEqn = DEqn.add_source(div_sig, mesh)
        Ddata, perf = linear.solve(mesh, DEqn, D.data, d_ctrl)
        D = D.with_data(Ddata)
        if it == 0:
            init_res = perf
        diag["D"] = perf
    diag["D_initial"] = init_res.initial_residual

    new_state = dict(state)
    new_state.update(D=D)
    if not cfg.steady:
        new_state.update(D0=D.data, D00=D0)
    return new_state, diag


def sigma_of(mesh, D: VolField, cfg: SolidConfig):
    """Full stress tensor sigma = mu(gradD + gradD.T) + lam I tr
    [nC,3,3] (multiplied back by rho to physical units)."""
    mu, lam = lame(cfg)
    g = fvc.grad(mesh, D)
    I3 = jnp.eye(3, dtype=g.dtype)
    tr = jnp.trace(g, axis1=1, axis2=2)
    sig = mu * (g + jnp.swapaxes(g, 1, 2)) + lam * tr[:, None, None] * I3
    return sig * cfg.rho


def initial_state(mesh, D: VolField, steady: bool = False) -> Dict:
    st = {"D": D}
    if not steady:
        st.update(D0=D.data, D00=D.data)
    return st


def make_step(mesh, cfg: SolidConfig):
    from .jitstep import jit_with_mesh

    return jit_with_mesh(
        lambda m, state, dt: solid_step(m, state, dt, cfg), mesh,
        (cfg.d_controls,))
