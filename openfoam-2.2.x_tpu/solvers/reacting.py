"""reactingFoam — compressible reacting flow with finite-rate
chemistry (laminar combustion model).

Rebuild of reference: applications/solvers/combustion/reactingFoam/
(YEqn.H, EEqn.H + chemistryModel::solve; combustion model `laminar`).
Operator-split design per time step:

  1. flow step: the rhoPimpleFoam pressure-based compressible step
     (solvers/rhopimple.py) — momentum/energy/pressure on the mass flux
  2. species transport: implicit ddt(rho,Yi)+div(phi,Yi)
     -laplacian(rho*D,Yi) for every species, solved MULTI-RHS (all
     species in ONE Krylov while_loop — the same trick vector solves
     use; the reference loops species sequentially)
  3. chemistry: vmapped stiff Rosenbrock integration of the reaction
     system in every cell (models/chemistry.py) + explicit heat release
     into T

Mass-fraction normalisation after transport+reaction keeps sum(Y)=1
(the reference normalises via the inert species).
"""

from __future__ import annotations

import dataclasses as _dc
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.dimensions import DimensionSet
from ..core.fields import VolField
from ..ops import fvm, slot as slot_mod, schemes as schemes_mod, surface
from . import linear
from .rhopimple import RhoPimpleConfig, rhopimple_step, _rho_ddt


class ReactingConfig(NamedTuple):
    flow: RhoPimpleConfig        # the underlying compressible config
    chem: Any                    # models/chemistry.ChemistryModel
    W: Any                       # [nS] molecular weights [kg/kmol]
    Sc: float = 0.7              # Schmidt number for species diffusion
    chem_rtol: float = 1e-4
    y_controls: Dict = None
    combustion: Any = None       # models/combustion.Combustion closure
                                 # (None -> laminar direct integration)
    # reactingMixture thermo (reference: hePsiThermo<reactingMixture>,
    # src/thermophysicalModels/reactionThermo/): per-species janaf
    # NASA-7 coefficient tables -> per-cell mixture R(Y) and Cp(Y,T)
    # carried in the state and honoured by the flow step's EOS
    cp_lo: Any = None            # [nS,7] low-T janaf coefficients
    cp_hi: Any = None            # [nS,7]
    t_common: Any = None         # [nS]

    def mixture_RCp(self, Y, T):
        """(R_mix [nC], cp_mix [nC]) from mass fractions (reference:
        reactingMixture via multiComponentMixture::cellMixture)."""
        R_UNIV = 8314.47
        Wv = jnp.asarray(self.W, Y.dtype)
        R_mix = R_UNIV * jnp.sum(Y / Wv[None, :], axis=1)
        if self.cp_lo is None:
            return R_mix, None
        lo = jnp.asarray(self.cp_lo, Y.dtype)      # [nS,7]
        hi = jnp.asarray(self.cp_hi, Y.dtype)
        tc = jnp.asarray(self.t_common, Y.dtype)
        Tc = jnp.clip(T, 200.0, 5000.0)
        a = jnp.where((Tc[:, None] < tc[None, :])[:, :, None],
                      lo[None, :, :], hi[None, :, :])   # [nC,nS,7]
        poly = (a[..., 0] + Tc[:, None] * (a[..., 1] + Tc[:, None]
                * (a[..., 2] + Tc[:, None] * (a[..., 3]
                   + Tc[:, None] * a[..., 4]))))        # Cp_i/R
        cp_i = poly * R_UNIV / Wv[None, :]              # J/kg/K
        cp_mix = jnp.sum(Y * cp_i, axis=1)
        return R_mix, cp_mix


def reacting_step(mesh, state: Dict, dt: Any, cfg: ReactingConfig
                  ) -> Tuple[Dict, Dict]:
    th = cfg.flow.thermo
    y_ctrl = cfg.y_controls or {"solver": "PBiCGStab",
                                "tolerance": 1e-8, "relTol": 0.05,
                                "maxIter": 300}
    nif = mesh.n_internal_faces
    rdt = 1.0 / dt

    # -- 1. flow ------------------------------------------------------------
    state, diag = rhopimple_step(mesh, state, dt, cfg.flow)
    T: VolField = state["T"]
    phi = state["phi"]
    rho = state["rho0"] if not cfg.flow.steady else jnp.maximum(
        th.rho(state["p"].data, T.data), cfg.flow.rho_min)
    rho0 = state.get("rho_prev", rho)

    # -- 2. species transport (multi-RHS) ------------------------------------
    Y: VolField = state["Y"]          # [nC, nS]
    Y0 = state.get("Y0", Y.data)
    phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    mu = th.mu_T(T.data) if th.sutherland_As > 0 else \
        jnp.full(mesh.n_cells, th.mu, mesh.v.dtype)
    gamma = mu / cfg.Sc               # rho*D
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
    Ydata, yperf = linear.solve(mesh, YEqn, Y.data, y_ctrl)
    Ydata = jnp.clip(Ydata, 0.0, 1.0)
    diag["Y"] = yperf

    # -- 3. chemistry (operator split) ---------------------------------------
    Wv = jnp.asarray(cfg.W, mesh.v.dtype)
    c = rho[:, None] * Ydata / Wv[None, :]          # [kmol/m^3]
    if cfg.combustion is not None:
        # closure-scaled rates (PaSR / infinitelyFastChemistry /
        # laminar — models/combustion.py)
        from ..models import combustion as comb_mod

        eps_t = comb_mod.epsilon_of(state.get("turb"))
        nut = (cfg.flow.turb.nut(mesh, state["turb"])
               if cfg.flow.turb is not None and "turb" in state
               else jnp.zeros_like(rho))
        nu_eff = mu / jnp.maximum(rho, cfg.flow.rho_min) + nut
        c_new = cfg.combustion.advance(c, T.data, dt, rtol=cfg.chem_rtol,
                                       epsilon=eps_t, nu_eff=nu_eff)
    else:
        c_new = cfg.chem.solve(c, T.data, dt, rtol=cfg.chem_rtol)
    # heat release -> temperature (explicit): dT = -sum hf dc / (rho cp)
    dc = c_new - c
    q = -(dc @ cfg.chem.hf) * rdt                   # J/m^3/s
    # reactingMixture mode engages when janaf tables are supplied
    # (the app parses thermo.compressibleGas); without them the
    # single-mixture thermo closure is preserved
    mixture_mode = cfg.cp_lo is not None
    if mixture_mode:
        R_mix, cp_mix = cfg.mixture_RCp(jnp.clip(
            c_new * jnp.asarray(cfg.W, mesh.v.dtype)[None, :]
            / rho[:, None], 0.0, 1.0), T.data)
        cp = cp_mix
    else:
        R_mix, cp_mix = None, None
        cp = th.Cp_of(T.data)
    T = T.with_data(T.data + dt * q / (rho * cp))
    T = T.correct_boundary_conditions(mesh)
    Ydata = c_new * Wv[None, :] / rho[:, None]
    # normalise (inert-species closure)
    Ydata = Ydata / jnp.maximum(jnp.sum(Ydata, axis=1,
                                        keepdims=True), 1e-12)
    Y = Y.with_data(Ydata)
    diag["Qdot_max"] = jnp.max(jnp.abs(q))

    new_state = dict(state)
    new_state.update(T=T, Y=Y, Y0=Ydata, rho_prev=rho)
    if mixture_mode:
        new_state["R_mix"] = R_mix
        new_state["cp_mix"] = cp_mix
    if not cfg.flow.steady:
        # close the split thermodynamically: constant-volume heat
        # release keeps rho, raises T AND p = rho R T together; all
        # old-time levels move to the post-chemistry state so the next
        # flow step starts from a consistent (p, T, rho) triple
        p_new = rho * (R_mix if mixture_mode else th.R) * T.data
        pfld: VolField = state["p"]
        new_state["p"] = pfld.with_data(p_new)
        new_state["p0"] = p_new
        new_state["T0"] = T.data
    return new_state, diag


def initial_state(mesh, U, p, T, Y: VolField, thermo,
                  steady: bool = False) -> Dict:
    from .rhopimple import initial_state as rp_init

    st = rp_init(mesh, U, p, T, thermo, steady=steady)
    st["Y"] = Y
    st["Y0"] = Y.data
    return st


def seed_mixture_state(st, cfg: "ReactingConfig"):
    """Initialise the per-cell mixture R/Cp so the FIRST flow step
    already runs on the composition-dependent EOS (reactingMixture
    mode only — requires the janaf tables)."""
    if cfg.cp_lo is None:
        return st
    R_mix, cp_mix = cfg.mixture_RCp(st["Y"].data, st["T"].data)
    st["R_mix"] = R_mix
    st["cp_mix"] = cp_mix
    return st


def make_step(mesh, cfg: ReactingConfig):
    from .jitstep import jit_with_mesh

    return jit_with_mesh(
        lambda m, state, dt: reacting_step(m, state, dt, cfg), mesh,
        (cfg.flow.p_controls, cfg.flow.p_controls_final,
         cfg.flow.u_controls, cfg.flow.e_controls, cfg.y_controls))
