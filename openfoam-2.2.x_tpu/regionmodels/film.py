"""Surface film models: kinematicSingleLayer + thermoSingleLayer.

Reference: src/regionModels/surfaceFilmModels/
  - kinematicSingleLayer/kinematicSingleLayer.C  (solveContinuity,
    solveMomentum: ddt(delta) + div(delta U) = S_mass/rho;
    ddt(delta U) + div(delta U U) = tangential gravity + wall shear
    + surface shear + S_mom)
  - thermoSingleLayer/thermoSingleLayer.C        (+ film energy with
    convective exchange and phase-change evaporation)

Formulation (depth-integrated laminar film, Nusselt velocity profile):
    wall shear   tau_w = 3 nu U / delta      (parabolic profile)
    gravity      g_t   = g - n (n.g)         (tangential component)
so a draining film reaches U_inf = g_t delta^2 / (3 nu).

Design: explicit upwind edge fluxes with scatter-adds over the
film mesh (a few-thousand-face region — host-trivial next to the
primary solve); the whole step is one fused device program, safe to
call inside the primary solver's jitted step. Evaporation is a
documented simplification of the reference's phaseChangeModel:
m_evap = evap_coeff * max(T_film - T_sat, 0) [kg/m^2/s].
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax.numpy as jnp

from .filmmesh import FilmMesh

_SMALL = 1e-8


class FilmConfig(NamedTuple):
    nu: float = 1e-6            # film kinematic viscosity [m^2/s]
    rho: float = 1000.0         # film density [kg/m^3]
    g: Tuple[float, float, float] = (0.0, -9.81, 0.0)
    thermo: bool = False        # thermoSingleLayer mode
    cp: float = 4187.0
    T_sat: float = 373.15
    evap_coeff: float = 0.0     # [kg/m^2/s/K] above saturation
    h_conv: float = 0.0         # film<->primary convective coeff [W/m^2/K]
    L_vap: float = 2.26e6       # latent heat [J/kg]
    delta_min: float = 1e-8     # numerical film-height floor


def film_init(fm: FilmMesh, cfg: FilmConfig, delta0=0.0, T0=300.0
              ) -> Dict[str, Any]:
    dt = fm.area.dtype
    st = {
        "delta": jnp.broadcast_to(jnp.asarray(delta0, dt),
                                  (fm.n_faces,)) + jnp.zeros(
                                      fm.n_faces, dt),
        "Uf": jnp.zeros((fm.n_faces, 3), dt),
    }
    if cfg.thermo:
        st["Tf"] = jnp.broadcast_to(jnp.asarray(T0, dt),
                                    (fm.n_faces,)) + jnp.zeros(
                                        fm.n_faces, dt)
    return st


def _edge_div(fm: FilmMesh, flux: Any, width: Optional[int] = None
              ) -> Any:
    """Divergence of edge fluxes -> per-film-cell, divided by area."""
    shape = ((fm.n_faces,) if flux.ndim == 1
             else (fm.n_faces, flux.shape[1]))
    out = jnp.zeros(shape, flux.dtype)
    out = out.at[fm.e_own].add(flux)
    out = out.at[fm.e_nbr].add(-flux)
    a = fm.area if flux.ndim == 1 else fm.area[:, None]
    return out / a


def film_step(fm: FilmMesh, state: Dict[str, Any], dt: Any,
              cfg: FilmConfig,
              S_mass: Any = 0.0,       # [nF] kg/m^2/s impingement
              S_mom: Any = 0.0,        # [nF,3] N/m^2 surface shear
              q_wall: Any = 0.0,       # [nF] W/m^2 from the wall
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """One explicit film step (reference: surfaceFilmModel::evolve)."""
    delta = state["delta"]
    Uf = state["Uf"]
    g = jnp.asarray(cfg.g, delta.dtype)

    # -- edge fluxes (upwind) ------------------------------------------------
    u_e = 0.5 * (Uf[fm.e_own] + Uf[fm.e_nbr])
    un = jnp.sum(u_e * fm.e_m, axis=1)            # [nE] m^3/s per height
    up = jnp.where(un >= 0.0, fm.e_own, fm.e_nbr)
    d_up = delta[up]
    phi = un * d_up                                # [nE] m^3/s

    # -- evaporation (thermo mode) -------------------------------------------
    if cfg.thermo and cfg.evap_coeff > 0.0:
        Tf = state["Tf"]
        m_ev = cfg.evap_coeff * jnp.maximum(Tf - cfg.T_sat, 0.0)
        # cannot evaporate more than the film holds
        m_ev = jnp.minimum(m_ev, cfg.rho * delta / dt)
    else:
        m_ev = jnp.zeros_like(delta)

    # -- continuity ----------------------------------------------------------
    ddelta = -_edge_div(fm, phi) + (S_mass - m_ev) / cfg.rho
    delta_new = jnp.maximum(delta + dt * ddelta, 0.0)

    # -- momentum ------------------------------------------------------------
    mom_flux = phi[:, None] * Uf[up]               # [nE,3]
    g_t = g[None, :] - fm.n * jnp.sum(fm.n * g[None, :],
                                      axis=1, keepdims=True)
    d_eff = jnp.maximum(delta, cfg.delta_min)
    tau_w = 3.0 * cfg.nu * Uf / d_eff[:, None]     # per unit depth
    dmU = (-_edge_div(fm, mom_flux)
           + delta[:, None] * g_t
           - tau_w
           + jnp.asarray(S_mom) / cfg.rho)
    mU_new = delta[:, None] * Uf + dt * dmU
    d_new_eff = jnp.maximum(delta_new, cfg.delta_min)
    Uf_new = mU_new / d_new_eff[:, None]
    # keep U tangential (project out any normal component)
    Uf_new = Uf_new - fm.n * jnp.sum(fm.n * Uf_new, axis=1,
                                     keepdims=True)
    Uf_new = jnp.where(delta_new[:, None] > cfg.delta_min, Uf_new, 0.0)

    new = dict(state)
    new["delta"] = delta_new
    new["Uf"] = Uf_new
    diag = {
        "mass": jnp.sum(cfg.rho * delta_new * fm.area),
        "evap_rate": jnp.sum(m_ev * fm.area),
        "delta_max": jnp.max(delta_new),
    }

    # -- energy (thermo mode) ------------------------------------------------
    if cfg.thermo:
        Tf = state["Tf"]
        T_flux = phi * Tf[up]
        # depth-integrated energy: d(delta T)/dt + div(delta U T) =
        # (q_wall + q_conv - m_ev L)/ (rho cp)
        q_net = (jnp.asarray(q_wall) - m_ev * cfg.L_vap)
        dTd = -_edge_div(fm, T_flux) + q_net / (cfg.rho * cfg.cp)
        Td_new = delta * Tf + dt * dTd
        Tf_new = jnp.where(delta_new > cfg.delta_min,
                           Td_new / d_new_eff, Tf)
        new["Tf"] = Tf_new
        diag["T_max"] = jnp.max(Tf_new)
    return new, diag
