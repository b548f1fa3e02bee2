"""Pyrolysis region: 1D in-depth reacting solid columns.

Reference: src/regionModels/pyrolysisModels/reactingOneDim/
(reactingOneDim.C — solveEnergy/solveSpeciesMass: in-depth heat
conduction through the solid with Arrhenius mass loss releasing fuel
gas at the exposed surface).

Formulation, per wall face (a column of nL layers, z into the solid):
    rho cp dT/dt = d/dz (k dT/dz),  -k dT/dz|surf = q_in (exposed),
                                     dT/dz|back = 0 (insulated)
    d(rho_s)/dt = -A exp(-Ta/T) (rho_s - rho_char)
    m_gas [kg/m^2/s] = sum_layers -d(rho_s)/dt * dz

Design: columns are a [nF, nL] array advanced with an explicit
scheme subcycled inside lax.scan — all faces integrate as one fused
device program (the reference loops region cells through its fvMesh).
Pyrolysis heat sink (endothermic Qr) is folded in via cfg.h_pyro.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp


class PyrolysisConfig(NamedTuple):
    n_layers: int = 8
    thickness: float = 0.01     # [m]
    k_s: float = 0.2            # solid conductivity [W/m/K]
    rho_s0: float = 700.0       # virgin solid density [kg/m^3]
    rho_char: float = 100.0     # char (non-pyrolysable) density
    cp_s: float = 1500.0        # [J/kg/K]
    A: float = 1e8              # Arrhenius pre-exponential [1/s]
    Ta: float = 15000.0         # activation temperature [K]
    h_pyro: float = 1e5         # heat of pyrolysis [J/kg] (endothermic)
    n_sub: int = 4              # explicit subcycles per step


def pyro_init(n_faces: int, cfg: PyrolysisConfig, T0=300.0,
              dtype=jnp.float32) -> Dict[str, Any]:
    return {
        "Ts": jnp.full((n_faces, cfg.n_layers), T0, dtype),
        "rho_s": jnp.full((n_faces, cfg.n_layers), cfg.rho_s0, dtype),
    }


def pyro_step(state: Dict[str, Any], dt: Any, cfg: PyrolysisConfig,
              q_in: Any) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Advance all columns over dt under surface heat flux q_in [nF]
    (W/m^2, positive into the solid)."""
    dz = cfg.thickness / cfg.n_layers
    sub_dt = dt / cfg.n_sub
    alpha = cfg.k_s / (cfg.rho_s0 * cfg.cp_s)
    q_in = jnp.asarray(q_in)

    def sub(carry, _):
        Ts, rho_s = carry
        # conduction: interior second difference, surface flux BC at
        # layer 0, insulated back
        flux_in = q_in / (cfg.rho_s0 * cfg.cp_s * dz)   # [nF] K/s
        lap = (jnp.roll(Ts, -1, axis=1) - 2.0 * Ts
               + jnp.roll(Ts, 1, axis=1)) / dz ** 2
        # boundary rows: one-sided
        lap = lap.at[:, 0].set((Ts[:, 1] - Ts[:, 0]) / dz ** 2)
        lap = lap.at[:, -1].set((Ts[:, -2] - Ts[:, -1]) / dz ** 2)
        # pyrolysis mass loss (endothermic sink)
        rate = cfg.A * jnp.exp(-cfg.Ta / jnp.maximum(Ts, 1.0)) \
            * jnp.maximum(rho_s - cfg.rho_char, 0.0)    # kg/m^3/s
        dT = alpha * lap - rate * cfg.h_pyro / (cfg.rho_s0 * cfg.cp_s)
        dT = dT.at[:, 0].add(flux_in)
        Ts_n = Ts + sub_dt * dT
        rho_n = jnp.maximum(rho_s - sub_dt * rate, cfg.rho_char)
        return (Ts_n, rho_n), None

    (Ts, rho_s), _ = jax.lax.scan(sub, (state["Ts"], state["rho_s"]),
                                  None, length=cfg.n_sub)
    m_gas = jnp.sum(state["rho_s"] - rho_s, axis=1) * dz / dt  # [nF]
    new = {"Ts": Ts, "rho_s": rho_s}
    diag = {
        "T_surf_max": jnp.max(Ts[:, 0]),
        "m_gas": m_gas,
        "solid_mass": jnp.sum(rho_s, axis=1) * dz,
    }
    return new, diag
