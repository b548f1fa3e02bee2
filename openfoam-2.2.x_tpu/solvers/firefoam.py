"""fireFoam — buoyancy-driven diffusion-flame fire with optional
pyrolysing fuel surfaces and a suppressing water film.

Rebuild of reference: applications/solvers/combustion/fireFoam/
(YEqn.H/hsEqn.H with infinitelyFastChemistry and the surfaceFilm /
pyrolysis region coupling of the reactingParcelFilmFoam family).
Operator-split step:

  1. flow: buoyantPimpleFoam compressible buoyant step
     (solvers/buoyantrho.py, incl. optional P1 radiation)
  2. species: multi-RHS implicit transport of all nS mass fractions
     (one Krylov while_loop, as reactingFoam)
  3. combustion: models/combustion.py closure (default
     infinitelyFastChemistry — the reference fireFoam default),
     constant-pressure heat release into T
  4. regions (optional): pyrolysis columns under `burning` patch faces
     receive the convective+radiative wall heat flux and release fuel
     gas mass into the adjacent cells; a water film on `film` patches
     evaporates against the same flux and cools the wall cells.

The region coupling is explicit (one-step lag), matching the
reference's region-model evolve() ordering.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax.numpy as jnp

from ..core.dimensions import DimensionSet
from ..core.fields import VolField
from ..ops import fvm, schemes as schemes_mod, slot as slot_mod, surface
from . import linear
from .buoyantrho import BuoyantRhoConfig, buoyantrho_step, _rho_ddt


class FireConfig(NamedTuple):
    flow: BuoyantRhoConfig
    chem: Any                    # models/chemistry.ChemistryModel
    W: Any                       # [nS] molecular weights
    combustion: Any = None       # models/combustion.Combustion
    Sc: float = 0.7
    y_controls: Dict = None
    fuel_index: int = 0          # which species the pyrolysis gas feeds
    # region models (None = off)
    pyro_mesh: Any = None        # regionmodels.FilmMesh over burning patches
    pyro_cfg: Any = None         # regionmodels.PyrolysisConfig
    film_mesh: Any = None        # FilmMesh over film patches
    film_cfg: Any = None         # regionmodels.FilmConfig (thermo=True)
    h_conv: float = 20.0         # wall convective coefficient [W/m^2/K]
    T_ref_wall: float = 300.0    # solid/film reference temperature


def fire_step(mesh, state: Dict, dt: Any, cfg: FireConfig
              ) -> Tuple[Dict, Dict]:
    th = cfg.flow.thermo
    y_ctrl = cfg.y_controls or {"solver": "PBiCGStab",
                                "tolerance": 1e-8, "relTol": 0.05,
                                "maxIter": 300}
    nif = mesh.n_internal_faces
    rdt = 1.0 / dt

    state, diag = buoyantrho_step(mesh, state, dt, cfg.flow)
    T: VolField = state["T"]
    phi = state["phi"]
    rho = state["rho0"]
    rho0 = state.get("rho_prev", rho)

    # -- species (multi-RHS, as reactingFoam) --------------------------------
    Y: VolField = state["Y"]
    Y0 = state.get("Y0", Y.data)
    phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    mu = th.mu_T(T.data) if th.sutherland_As > 0 else \
        jnp.full(mesh.n_cells, th.mu, mesh.v.dtype)
    gamma = mu / cfg.Sc
    g_slot = slot_mod.interpolate(mesh, gamma,
                                  bv=surface.owner_to_b(mesh, gamma))
    w_slot = schemes_mod.weights_slot(mesh, phi_slot, "upwind", Y)
    YEqn = (_rho_ddt(mesh, Y, rho, rho0, Y0, rdt)
            + fvm.div(mesh, phi, Y, phi_slot=phi_slot,
                      slot_weights=w_slot,
                      phi_dims=DimensionSet.of(1, 0, -1))
            - fvm.laplacian(mesh, slot_mod.to_flat(mesh, g_slot), Y,
                            corrected=False,
                            gamma_dims=DimensionSet.of(1, -1, -1),
                            gamma_slot=g_slot))
    # pyrolysis fuel release into the wall-adjacent cells
    if cfg.pyro_mesh is not None and "pyro" in state:
        m_gas = state.get("pyro_m_gas",
                          jnp.zeros(cfg.pyro_mesh.n_faces, rho.dtype))
        src = jnp.zeros((mesh.n_cells, Y.data.shape[1]), rho.dtype)
        src = src.at[cfg.pyro_mesh.owner_cells, cfg.fuel_index].add(
            m_gas * cfg.pyro_mesh.area)       # kg/s into the cell
        YEqn = YEqn.add_source(src / mesh.v[:, None], mesh)
    Ydata, yperf = linear.solve(mesh, YEqn, Y.data, y_ctrl)
    Ydata = jnp.clip(Ydata, 0.0, 1.0)
    diag["Y"] = yperf

    # -- combustion (constant-pressure heat release) -------------------------
    Wv = jnp.asarray(cfg.W, mesh.v.dtype)
    c = rho[:, None] * Ydata / Wv[None, :]
    if cfg.combustion is not None:
        from ..models import combustion as comb_mod

        eps_t = comb_mod.epsilon_of(state.get("turb"))
        nut = (cfg.flow.turb.nut(mesh, state["turb"])
               if cfg.flow.turb is not None and "turb" in state
               else jnp.zeros_like(rho))
        c_new = cfg.combustion.advance(
            c, T.data, dt, epsilon=eps_t,
            nu_eff=mu / jnp.maximum(rho, cfg.flow.rho_min) + nut)
    else:
        c_new = cfg.chem.solve(c, T.data, dt)
    dc = c_new - c
    q = -(dc @ cfg.chem.hf) * rdt                 # J/m^3/s
    cp = th.Cp_of(T.data)
    T = T.with_data(T.data + dt * q
                    / (jnp.maximum(rho, cfg.flow.rho_min) * cp))
    T = T.correct_boundary_conditions(mesh)
    Ydata = c_new * Wv[None, :] / rho[:, None]
    Ydata = Ydata / jnp.maximum(
        jnp.sum(Ydata, axis=1, keepdims=True), 1e-12)
    Y = Y.with_data(Ydata)
    diag["Qdot_max"] = jnp.max(q)

    new_state = dict(state)
    new_state.update(T=T, Y=Y, Y0=Ydata, rho_prev=rho, T0=T.data)

    # -- region models (explicit coupling) -----------------------------------
    if cfg.pyro_mesh is not None and "pyro" in state:
        from ..regionmodels import pyro_step

        pm = cfg.pyro_mesh
        T_wallcell = T.data[pm.owner_cells]
        q_in = cfg.h_conv * (T_wallcell - state["pyro"]["Ts"][:, 0])
        pyro_new, pdiag = pyro_step(state["pyro"], dt, cfg.pyro_cfg,
                                    jnp.maximum(q_in, 0.0))
        new_state["pyro"] = pyro_new
        new_state["pyro_m_gas"] = pdiag["m_gas"]
        diag["pyro_T_surf"] = pdiag["T_surf_max"]
        diag["pyro_m_gas"] = jnp.sum(pdiag["m_gas"] * pm.area)
    if cfg.film_mesh is not None and "film" in state:
        from ..regionmodels import film_step

        fmm = cfg.film_mesh
        T_wallcell = T.data[fmm.owner_cells]
        q_wall = cfg.h_conv * (T_wallcell - state["film"]["Tf"])
        film_new, fdiag = film_step(fmm, state["film"], dt,
                                    cfg.film_cfg, q_wall=q_wall)
        new_state["film"] = film_new
        # evaporative cooling of the adjacent gas cells
        q_cool = fdiag["evap_rate"]
        diag["film_mass"] = fdiag["mass"]
        diag["film_evap"] = q_cool
    return new_state, diag


def initial_state(mesh, U, p_rgh, T, Y: VolField, thermo,
                  g=(0.0, -9.81, 0.0), turb_state=None,
                  cfg: Optional[FireConfig] = None) -> Dict:
    from .buoyantrho import initial_state as b_init

    st = b_init(mesh, U, p_rgh, T, thermo, g=g, turb_state=turb_state)
    st["Y"] = Y
    st["Y0"] = Y.data
    if cfg is not None and cfg.pyro_mesh is not None:
        from ..regionmodels import pyro_init

        st["pyro"] = pyro_init(cfg.pyro_mesh.n_faces, cfg.pyro_cfg,
                               T0=cfg.T_ref_wall, dtype=mesh.v.dtype)
        st["pyro_m_gas"] = jnp.zeros(cfg.pyro_mesh.n_faces,
                                     mesh.v.dtype)
    if cfg is not None and cfg.film_mesh is not None:
        from ..regionmodels import film_init

        st["film"] = film_init(cfg.film_mesh, cfg.film_cfg,
                               delta0=1e-4, T0=cfg.T_ref_wall)
    return st


def make_step(mesh, cfg: FireConfig):
    from .jitstep import jit_with_mesh

    return jit_with_mesh(
        lambda m, state, dt: fire_step(m, state, dt, cfg), mesh,
        (cfg.flow.p_controls, cfg.flow.p_controls_final,
         cfg.flow.u_controls, cfg.flow.e_controls, cfg.y_controls))
