"""reactingcloud — evaporating / devolatilising parcel physics.

Rebuild of reference: src/lagrangian/intermediate/submodels/
{Reacting/PhaseChangeModel/LiquidEvaporation,
 ReactingMultiphase/DevolatilisationModel/SingleKineticRateDevolatilisation,
 ReactingMultiphase/SurfaceReactionModel (char burnout),
 Kinematic/ParticleForces, spray/BreakupModel/ReitzDiwakar} and the
solvers applications/solvers/lagrangian/{reactingParcelFoam,
coalChemistryFoam,sprayFoam}.

Design: the extra physics are ELEMENTWISE updates on the same
fixed-slot struct-of-arrays cloud (no new tracking machinery):

- Evaporation (d^2-law with Ranz-Marshall Sherwood correction):
      d(d^2)/dt = -K_evap * Sh/2,   Sh = 2 + 0.6 Re^1/2 Sc^1/3
  transferring parcel mass to a per-cell vapour source and drawing the
  latent heat from the carrier.
- Single-kinetic-rate devolatilisation of the volatile mass fraction
  (coal):  dYv/dt = -A1 exp(-E/RT_p) Yv,
  followed by a diffusion-limited char burnout that shrinks the
  diameter and releases the char heating value.
- Reitz-Diwakar bag breakup: parcels whose Weber number
  We = rho_f |u_rel|^2 d / sigma exceeds We_crit shrink toward the
  stable diameter with the bag time constant (sprayFoam).

Per-cell sources come from `jax.ops.segment_sum` over parcels — the
cloud-to-carrier coupling pattern `momentum_source` already uses.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from . import Cloud, CloudConfig


class EvapConfig(NamedTuple):
    K_evap: float = 1e-7       # base d^2-law constant [m^2/s]
    Sc: float = 0.7            # carrier Schmidt number
    L_vap: float = 2.26e6      # latent heat [J/kg]
    T_boil: float = 373.0      # no evaporation below T_wet? (gate)
    d_min: float = 1e-7


class CoalConfig(NamedTuple):
    A1: float = 2e5            # devolatilisation pre-exponential [1/s]
    E: float = 7.4e7           # activation energy [J/kmol]
    Yvol0: float = 0.4         # initial volatile mass fraction
    h_vol: float = 3.0e7       # volatile heating value [J/kg]
    h_char: float = 3.28e7     # char heating value [J/kg]
    char_rate: float = 5e-3    # diffusion-limited burnout d-rate [m/s /K^0.75-ish]
    d_min: float = 1e-6


class BreakupConfig(NamedTuple):
    sigma: float = 0.026       # droplet surface tension [N/m]
    rho_f: float = 1.0
    we_crit: float = 6.0       # bag breakup threshold
    c_bag: float = 0.785       # bag time-constant coefficient (pi/4)


R_UNIV = 8314.47


def evaporate(cloud: Cloud, U_cell, T_cell, dt, cfg: CloudConfig,
              ecfg: EvapConfig, n_cells: int, n_parcels=1.0):
    """d^2-law evaporation. U_cell/T_cell are CARRIER CELL fields
    ([nC,3]/[nC]), gathered at each parcel's cell. Returns (cloud,
    vapour_mass_src [nC], heat_sink [nC] in W) — both already
    parcel-count weighted."""
    u_f = U_cell[cloud.cell]
    urel = jnp.linalg.norm(u_f - cloud.u, axis=1)
    Re = jnp.maximum(cfg.rho_f * urel * cloud.d / cfg.mu_f, 1e-10)
    Sh = 2.0 + 0.6 * jnp.sqrt(Re) * ecfg.Sc ** (1.0 / 3.0)
    d2 = cloud.d ** 2
    d2_new = jnp.maximum(d2 - dt * ecfg.K_evap * Sh / 2.0,
                         ecfg.d_min ** 2)
    d_new = jnp.sqrt(d2_new)
    dm = (cloud.rho * jnp.pi / 6.0 * (cloud.d ** 3 - d_new ** 3)
          * n_parcels)
    dm = jnp.where(cloud.active, jnp.maximum(dm, 0.0), 0.0)
    alive = cloud.active & (d_new > 1.5 * ecfg.d_min)
    cloud = cloud._replace(d=jnp.where(cloud.active, d_new, cloud.d),
                           active=alive)
    vap = jax.ops.segment_sum(dm, cloud.cell, num_segments=n_cells)
    heat = vap * ecfg.L_vap / dt
    return cloud, vap, heat


def liquid_evaporate(cloud: Cloud, U_cell, T_cell, p_cell, dt,
                     cfg: CloudConfig, liquid, n_cells: int,
                     n_parcels=1.0):
    """Liquid-properties phase change (reference: src/lagrangian/
    intermediate/submodels/Reacting/PhaseChangeModel/LiquidEvaporation/
    LiquidEvaporation.C): molar evaporation flux through the vapour
    film,

        kc  = Sh D / d                     (Ranz-Marshall Sherwood)
        Cs  = pv(Ts) / (Ru Ts)             (surface molar concentration)
        dm  = pi d^2 kc Cs W dt            (Cinf = 0, dry carrier)

    with pv/hl from the SLGThermo liquid package (models/liquids.py).
    Returns (cloud, vapour_mass_src [nC] kg, heat_sink [nC] W)."""
    u_f = U_cell[cloud.cell]
    urel = jnp.linalg.norm(u_f - cloud.u, axis=1)
    Re = jnp.maximum(cfg.rho_f * urel * cloud.d / cfg.mu_f, 1e-10)
    Sc = cfg.mu_f / jnp.maximum(cfg.rho_f * liquid.D, 1e-30)
    Sh = 2.0 + 0.6 * jnp.sqrt(Re) * Sc ** (1.0 / 3.0)
    Ts = liquid.Ts_clip(cloud.T if cloud.T is not None
                        else T_cell[cloud.cell])
    kc = Sh * liquid.D / jnp.maximum(cloud.d, 1e-9)
    Cs = liquid.pv(Ts) / (R_UNIV * Ts)
    mdot = jnp.pi * cloud.d ** 2 * kc * Cs * liquid.W   # [kg/s] per drop
    m_p = cloud.rho * jnp.pi / 6.0 * cloud.d ** 3
    dm1 = jnp.minimum(mdot * dt, m_p)                   # per droplet
    d3_new = jnp.maximum(cloud.d ** 3 - 6.0 / jnp.pi * dm1
                         / jnp.maximum(cloud.rho, 1e-3), 0.0)
    d_new = d3_new ** (1.0 / 3.0)
    dm = jnp.where(cloud.active, dm1 * n_parcels, 0.0)
    alive = cloud.active & (d_new > 1e-7)
    upd = dict(d=jnp.where(cloud.active, d_new, cloud.d), active=alive)
    if cloud.T is not None:
        # evaporative cooling of the droplet (reference: the -hl dm
        # term of the parcel energy equation)
        cp_l = liquid.cp(Ts)
        dT = dm1 * liquid.hl(Ts) / jnp.maximum(m_p * cp_l, 1e-30)
        upd["T"] = jnp.where(cloud.active,
                             jnp.maximum(cloud.T - dT, 200.0), cloud.T)
    cloud = cloud._replace(**upd)
    vap = jax.ops.segment_sum(dm, cloud.cell, num_segments=n_cells)
    heat = jax.ops.segment_sum(dm * liquid.hl(Ts), cloud.cell,
                               num_segments=n_cells) / dt
    return cloud, vap, heat


class CoalCloud(NamedTuple):
    """Kinematic cloud + volatile mass fraction per parcel."""
    base: Cloud
    yvol: Any      # [Np] remaining volatile fraction of parcel mass


def devolatilise(coal: CoalCloud, T_cell, dt, ccfg: CoalConfig,
                 n_cells: int, n_parcels=1.0):
    """Single kinetic rate (reference:
    SingleKineticRateDevolatilisation): releases volatile gas mass and
    its heating value; then diffusion-limited char burnout shrinks d.
    Returns (coal, fuel_gas_src [nC] kg, heat_src [nC] W)."""
    c = coal.base
    Tp = c.T if c.T is not None else T_cell[c.cell]
    kv = ccfg.A1 * jnp.exp(-ccfg.E / (R_UNIV * jnp.maximum(Tp, 200.0)))
    yv_new = coal.yvol * jnp.exp(-kv * dt)
    m_p = c.rho * jnp.pi / 6.0 * c.d ** 3 * n_parcels
    dm_vol = jnp.where(c.active, m_p * (coal.yvol - yv_new), 0.0)
    # char burnout after devolatilisation (shrinking sphere)
    burn = (coal.yvol < 0.02 * ccfg.Yvol0)
    d_new = jnp.where(burn & c.active,
                      jnp.maximum(c.d - dt * ccfg.char_rate,
                                  ccfg.d_min), c.d)
    dm_char = jnp.where(c.active,
                        c.rho * jnp.pi / 6.0 * (c.d ** 3 - d_new ** 3)
                        * n_parcels, 0.0)
    alive = c.active & (d_new > 1.5 * ccfg.d_min)
    base = c._replace(d=d_new, active=alive)
    fuel = jax.ops.segment_sum(dm_vol, c.cell, num_segments=n_cells)
    heat = jax.ops.segment_sum(
        dm_vol * ccfg.h_vol + dm_char * ccfg.h_char, c.cell,
        num_segments=n_cells) / dt
    return CoalCloud(base=base, yvol=yv_new), fuel, heat


def reitz_diwakar_breakup(cloud: Cloud, U_cell, dt,
                          bcfg: BreakupConfig) -> Cloud:
    """Bag breakup (reference: spray/BreakupModel/ReitzDiwakar):
    parcels above We_crit relax toward the critical-Weber stable
    diameter with the bag characteristic time."""
    u_f = U_cell[cloud.cell]
    urel2 = jnp.sum((u_f - cloud.u) ** 2, axis=1)
    We = bcfg.rho_f * urel2 * cloud.d / bcfg.sigma
    d_stable = bcfg.we_crit * bcfg.sigma / jnp.maximum(
        bcfg.rho_f * urel2, 1e-30)
    # tau_bag = C sqrt(rho_p d^3 / (2 sigma))
    tau = bcfg.c_bag * jnp.sqrt(cloud.rho * cloud.d ** 3
                                / (2.0 * bcfg.sigma))
    f = jnp.clip(dt / jnp.maximum(tau, 1e-12), 0.0, 1.0)
    d_new = jnp.where((We > bcfg.we_crit) & cloud.active,
                      cloud.d + f * (jnp.minimum(d_stable, cloud.d)
                                     - cloud.d),
                      cloud.d)
    return cloud._replace(d=d_new)
