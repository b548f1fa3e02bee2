"""rhoCentralFoam — density-based compressible solver with
central-upwind (Kurganov-Noelle-Petrova) fluxes.

Reference: applications/solvers/compressible/rhoCentralFoam/
(rhoCentralFoam.C + the createFields/flux machinery), which implements
the semi-discrete KNP/KT schemes of Kurganov et al. (2001) as described
in Greenshields et al. (IJNMF 2010). Fully explicit — zero linear
solves in the inviscid path, so every step is pure gather/vector math:
the most accelerator-friendly solver in the suite.

State: conservative (rho, rhoU, rhoE) cell fields; primitives + BCs
are reconstructed each step. Face reconstruction is first-order upwind
of each side (owner/neighbour) with optional MUSCL limited-linear
extrapolation (vanLeer/Minmod on cell gradients).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.fields import VolField
from ..models.thermo import PerfectGas
from ..ops import fvc, surface


class RhoCentralConfig(NamedTuple):
    thermo: PerfectGas
    flux_scheme: str = "Kurganov"    # Kurganov (KNP) | Tadmor (KT)
    second_order: bool = False       # MUSCL reconstruction (limiter WIP: first-order default)
    # BC data handled through the U/T/p VolFields in state


def _side_values(mesh, q: Any, grad_q: Optional[Any]):
    """Owner/neighbour side face values on internal faces, optionally
    MUSCL-extrapolated with minmod-limited gradients."""
    nif = mesh.n_internal_faces
    own = mesh.owner[:nif]
    nei = mesh.neighbour
    q_o = q[own]
    q_n = q[nei]
    if grad_q is None:
        return q_o, q_n
    d_o = mesh.cf[:nif] - mesh.c[own]
    d_n = mesh.cf[:nif] - mesh.c[nei]
    if q.ndim == 1:
        dq_o = jnp.sum(grad_q[own] * d_o, axis=1)
        dq_n = jnp.sum(grad_q[nei] * d_n, axis=1)
    else:
        dq_o = jnp.einsum("fi,fij->fj", d_o, grad_q[own])
        dq_n = jnp.einsum("fi,fij->fj", d_n, grad_q[nei])
    dq = q_n - q_o
    den = jnp.where(jnp.abs(dq) > 1e-30, dq, 1e-30)
    # minmod-limit the one-sided extrapolation against the face jump:
    # owner extrapolates along +dq, neighbour along -dq, both capped at
    # the midpoint (0.5*dq)
    lim_o = jnp.clip(dq_o / den, 0.0, 0.5)
    lim_n = jnp.clip(dq_n / (-den), 0.0, 0.5)
    return q_o + lim_o * dq, q_n + lim_n * (-dq)


def knp_fluxes(mesh, cfg: RhoCentralConfig,
               rho: Any, U: Any, T: Any,
               rho_b: Any, U_b: Any, T_b: Any,
               second_order: bool,
               mesh_un: Any = None) -> Tuple[Any, Any, Any, Any]:
    """Central-upwind face fluxes (mass, momentum, energy) on all
    faces + amaxSf for the acoustic Courant number. mesh_un: face
    mesh-motion normal velocity [nF] — convection and wave speeds go
    RELATIVE while the pressure work keeps the absolute face velocity
    (reference: rhoCentralDyMFoam's fvc::makeRelative on phiv with
    mesh.phi() folded into the energy flux)."""
    th = cfg.thermo
    nif = mesh.n_internal_faces
    sf = mesh.sf * mesh.face_active[:, None]
    mag_sf = mesh.mag_sf * mesh.face_active
    nhat = sf / jnp.maximum(mag_sf, 1e-30)[:, None]

    if second_order:
        # gradients with simple zero-gradient boundary closure
        g_rho = fvc.grad_component(mesh, rho, rho_b)
        g_T = fvc.grad_component(mesh, T, T_b)
        g_U = None  # keep U first-order for robustness of the vector part
    else:
        g_rho = g_T = g_U = None

    rho_p, rho_m = _side_values(mesh, rho, g_rho)
    T_p, T_m = _side_values(mesh, T, g_T)
    U_p, U_m = _side_values(mesh, U, None)

    # append boundary faces (single-sided: both sides = BC value)
    def full(a_p, a_m, b_vals):
        return (jnp.concatenate([a_p, b_vals], axis=0),
                jnp.concatenate([a_m, b_vals], axis=0))

    rho_p, rho_m = full(rho_p, rho_m, rho_b)
    T_p, T_m = full(T_p, T_m, T_b)
    U_p, U_m = full(U_p, U_m, U_b)

    T_p = jnp.maximum(T_p, 1e-6)
    T_m = jnp.maximum(T_m, 1e-6)
    p_p = th.p(rho_p, T_p)
    p_m = th.p(rho_m, T_m)
    c_p = th.c(T_p)
    c_m = th.c(T_m)
    un_p = jnp.sum(U_p * nhat, axis=1)
    un_m = jnp.sum(U_m * nhat, axis=1)
    if mesh_un is not None:
        un_p = un_p - mesh_un
        un_m = un_m - mesh_un

    a_pos = jnp.maximum(jnp.maximum(un_p + c_p, un_m + c_m), 0.0)
    a_neg = jnp.minimum(jnp.minimum(un_p - c_p, un_m - c_m), 0.0)
    amax = jnp.maximum(a_pos, -a_neg) * mag_sf

    if cfg.flux_scheme == "Tadmor":
        alpha = jnp.full_like(a_pos, 0.5)
        w_diff = 0.5 * jnp.maximum(a_pos, -a_neg)
    else:  # Kurganov (KNP)
        da = jnp.maximum(a_pos - a_neg, 1e-30)
        alpha = a_pos / da
        w_diff = alpha * (1.0 - alpha) * da

    # volumetric side fluxes phi± = alpha-weighted un (per unit area),
    # KNP form: aphiv± = alpha±*un± -/+ aOmega-style diffusion folded below
    e_p = th.e(T_p) + 0.5 * jnp.sum(U_p * U_p, axis=1)
    e_m = th.e(T_m) + 0.5 * jnp.sum(U_m * U_m, axis=1)

    def knp(q_p, q_m, adv_p, adv_m):
        """alpha*F+ + (1-alpha)*F- - w_diff*(q- - q+), per unit area."""
        a = alpha[:, None] if q_p.ndim == 2 else alpha
        w = w_diff[:, None] if q_p.ndim == 2 else w_diff
        return (a * adv_p * q_p + (1.0 - a) * adv_m * q_m
                - w * (q_m - q_p))

    mass = knp(rho_p, rho_m, un_p, un_m) * mag_sf
    mom = (knp(rho_p[:, None] * U_p, rho_m[:, None] * U_m,
               un_p[:, None], un_m[:, None])
           + (alpha * p_p + (1.0 - alpha) * p_m)[:, None] * nhat) * mag_sf[:, None]
    # pressure work uses the ABSOLUTE face velocity: un_rel + u_mesh
    un_pw_p = un_p if mesh_un is None else un_p + mesh_un
    un_pw_m = un_m if mesh_un is None else un_m + mesh_un
    ener = (knp(rho_p * e_p, rho_m * e_m, un_p, un_m)
            + (alpha * un_pw_p * p_p
               + (1.0 - alpha) * un_pw_m * p_m)) * mag_sf
    return mass, mom, ener, amax


def rhocentral_step(mesh, state: Dict, dt: Any, cfg: RhoCentralConfig
                    ) -> Tuple[Dict, Dict]:
    """One explicit Euler step (2-stage SSP-RK2 for second order)."""
    return _rhocentral_core(mesh, state, dt, cfg)


def _rhocentral_core(mesh, state: Dict, dt: Any,
                     cfg: RhoCentralConfig, mesh_un: Any = None
                     ) -> Tuple[Dict, Dict]:
    th = cfg.thermo
    U_f: VolField = state["U"]      # carries velocity BCs
    T_f: VolField = state["T"]      # carries temperature BCs
    rho_f: VolField = state["rho"]  # carries rho BCs (usually zeroGradient)

    def conservative_rhs(rho, rhoU, rhoE):
        U = rhoU / rho[:, None]
        e = rhoE / rho - 0.5 * jnp.sum(U * U, axis=1)
        T = th.T_from_e(jnp.maximum(e, 1e-10))
        # boundary values through the carried BC sets
        U_b = U_f.with_data(U).boundary_values(mesh)
        T_b = T_f.with_data(T).boundary_values(mesh)
        rho_b = rho_f.with_data(rho).boundary_values(mesh)
        mass, mom, ener, amax = knp_fluxes(
            mesh, cfg, rho, U, T, rho_b, U_b, T_b, cfg.second_order,
            mesh_un=mesh_un)
        d_rho = -surface.surface_sum(mesh, mass) / mesh.v
        d_rhoU = -surface.surface_sum(mesh, mom) / mesh.v[:, None]
        d_rhoE = -surface.surface_sum(mesh, ener) / mesh.v
        return d_rho, d_rhoU, d_rhoE, amax

    rho = state["rho"].data
    rhoU = state["rhoU"]
    rhoE = state["rhoE"]

    # SSP-RK2 (Heun): u1 = u + dt L(u); u2 = 0.5(u + u1 + dt L(u1))
    k1 = conservative_rhs(rho, rhoU, rhoE)
    rho1 = rho + dt * k1[0]
    rhoU1 = rhoU + dt * k1[1]
    rhoE1 = rhoE + dt * k1[2]
    k2 = conservative_rhs(rho1, rhoU1, rhoE1)
    rho_n = 0.5 * (rho + rho1 + dt * k2[0])
    rhoU_n = 0.5 * (rhoU + rhoU1 + dt * k2[1])
    rhoE_n = 0.5 * (rhoE + rhoE1 + dt * k2[2])

    rho_n = jnp.maximum(rho_n, 1e-8)
    U_n = rhoU_n / rho_n[:, None]
    e_n = rhoE_n / rho_n - 0.5 * jnp.sum(U_n * U_n, axis=1)
    T_n = th.T_from_e(jnp.maximum(e_n, 1e-10))
    p_n = th.p(rho_n, T_n)

    amax = k1[3]
    sum_amax = jnp.sum(amax[mesh.cface] * jnp.abs(mesh.csign), axis=1)
    co_max = 0.5 * jnp.max(sum_amax / mesh.v) * dt

    new_state = dict(state)
    new_state.update(
        rho=state["rho"].with_data(rho_n),
        rhoU=rhoU_n,
        rhoE=rhoE_n,
        U=U_f.with_data(U_n),
        T=T_f.with_data(T_n),
        p=p_n,
    )
    diag = {
        "courant_max": co_max,
        "rho_min": jnp.min(rho_n),
        "rho_max": jnp.max(rho_n),
        "mass": jnp.sum(rho_n * mesh.v),
    }
    return new_state, diag


def rhocentraldym_step(mesh, state: Dict, dt: Any,
                       cfg: RhoCentralConfig, pts_fn, umesh_fn
                       ) -> Tuple[Dict, Dict]:
    """rhoCentralDyMFoam (reference: applications/solvers/compressible/
    rhoCentralFoam/rhoCentralDyMFoam/): the KNP step on a solid-body
    moving mesh. Geometry recomputes on device per step; convection
    runs on the relative normal velocity, pressure work on the
    absolute one. Volume-preserving (rigid) motions only — the
    conservative update keeps V (documented; the reference's deforming
    movingCone case needs the V0 ddt, out of scope)."""
    from ..mesh import moving

    t = state["t"] + dt
    points = pts_fn(state["points0"], t)
    mesh_t = moving.update_geometry(mesh, points, state["topo"])
    mesh_un = (moving.mesh_flux(mesh_t, umesh_fn, t)
               * mesh_t.face_active
               / jnp.maximum(mesh_t.mag_sf, 1e-300))
    new_state, diag = _rhocentral_core(mesh_t, state, dt, cfg,
                                       mesh_un=mesh_un)
    new_state["t"] = t
    return new_state, diag


def make_step(mesh, cfg: RhoCentralConfig):
    @jax.jit
    def step(state, dt):
        return rhocentral_step(mesh, state, dt, cfg)

    return step


def make_chunk(mesh, cfg: RhoCentralConfig, n: int):
    @jax.jit
    def chunk(state, dt):
        def body(st, _):
            st, diag = rhocentral_step(mesh, st, dt, cfg)
            return st, diag

        state_out, diags = jax.lax.scan(body, state, None, length=n)
        return state_out, jax.tree_util.tree_map(lambda x: x[-1], diags)

    return chunk


def initial_state(mesh, rho: VolField, U: VolField, T: VolField,
                  cfg: RhoCentralConfig) -> Dict:
    th = cfg.thermo
    rhoU = rho.data[:, None] * U.data
    rhoE = rho.data * (th.e(T.data) + 0.5 * jnp.sum(U.data * U.data, axis=1))
    return {"rho": rho, "rhoU": rhoU, "rhoE": rhoE, "U": U, "T": T,
            "p": th.p(rho.data, T.data)}
