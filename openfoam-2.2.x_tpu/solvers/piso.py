"""icoFoam / pisoFoam — transient incompressible PISO solvers.

Rebuild of reference: applications/solvers/incompressible/icoFoam/
(icoFoam.C + pEqn logic) and pisoFoam/ (adds a turbulence model).
The whole time step — momentum predictor, PISO corrector loop with
non-orthogonal correctors, flux reconstruction — traces into ONE XLA
program; the Python loops below unroll at trace time (corrector counts
are static config, as in fvSolution).

Call stack mirror (SURVEY.md §3.1):
    momentum:  UEqn = ddt(U) + div(phi,U) - laplacian(nu,U)
               solve(UEqn == -grad(p))
    corrector: rAU=1/A(U); HbyA=rAU*H(U); phiHbyA=Sf.interp(HbyA)
               pEqn: laplacian(rAU,p) == div(phiHbyA); solve
               phi = phiHbyA - pEqn.flux(); U = HbyA - rAU*grad(p)
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..bc import patchfields as pf
from ..core.dimensions import dimFlux, dimPressure, dimTime, dimViscosity
from ..core.fields import VolField
from ..ops import fvc, fvm, surface
from . import linear


class PisoConfig(NamedTuple):
    nu: float
    n_correctors: int = 2
    n_non_orth: int = 0
    momentum_predictor: bool = True
    corrected: bool = False          # non-orthogonal laplacian correction
    corr_limit: float = 1.0          # limitedSnGrad coefficient (1 = plain corrected)
    div_scheme: str = "linear"       # for div(phi, U)
    ddt_scheme: str = "Euler"        # Euler | backward | CrankNicolson <oc>
    grad_scheme: str = "Gauss linear"  # for grad(p)
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_controls: Dict = None
    p_controls_final: Dict = None    # pFinal: used on the last corrector
    u_controls: Dict = None
    turb: Any = None        # TurbulenceModel (static; fields live in state["turb"])
    turb_controls: Dict = None
    nu_fn: Any = None       # non-Newtonian viscosity model: (mesh, U) -> nu [nC]
    fv_options: Any = None  # models/fvoptions.OptionList
    mrf: Any = None         # models/mrf.MRFZones


def ddt_matrix(mesh, field, state: Dict, rdt, scheme: str,
               key: str = "U") -> Any:
    """fvm ddt dispatch on the fvSchemes keyword (reference:
    fv::ddtScheme::New). State layout per scheme (set up by
    initial_state): Euler: {key}0; backward: {key}0, {key}00, rdt0;
    CrankNicolson <oc>: {key}0, ddt0_{key}, rdt0."""
    toks = scheme.split()
    old = state.get(f"{key}0", field.data)
    if toks[0] == "Euler":
        return fvm.ddt(mesh, field, old, rdt)
    if toks[0] == "backward":
        return fvm.ddt_backward(
            mesh, field, old, state.get(f"{key}00", old),
            rdt, state.get("rdt0", rdt))
    if toks[0] == "CrankNicolson":
        oc = float(toks[1]) if len(toks) > 1 else 1.0
        return fvm.ddt_crank_nicolson(
            mesh, field, old, state[f"ddt0_{key}"], rdt, oc,
            rdt0=state.get("rdt0"))
    if toks[0] == "steadyState":
        return fvm.ddt_steady(mesh, field)
    raise ValueError(f"unknown ddtScheme {scheme!r}")


def advance_time_state(state: Dict, new_state: Dict, U, rdt,
                       scheme: str) -> None:
    """Update the old-time entries in new_state after a completed step."""
    toks = scheme.split()
    new_state["U0"] = U.data
    if toks[0] == "backward":
        new_state["U00"] = state.get("U0", U.data)
        new_state["rdt0"] = rdt
    elif toks[0] == "CrankNicolson":
        oc = float(toks[1]) if len(toks) > 1 else 1.0
        new_state["ddt0_U"] = fvm.ddt_cn_update(
            U.data, state.get("U0", U.data), state["ddt0_U"], rdt, oc,
            rdt0=state.get("rdt0"))
        new_state["rdt0"] = rdt


def _default_controls():
    return (
        {"solver": "PCG", "preconditioner": "diagonal",
         "tolerance": 1e-6, "relTol": 0.0, "maxIter": 1000},
        {"solver": "smoothSolver", "tolerance": 1e-5, "relTol": 0.0,
         "maxIter": 1000, "nSweeps": 2},
    )


def needs_reference(p: VolField, mesh) -> bool:
    """Pressure needs a reference when no boundary fixes its value
    (reference: setRefCell / findRefCell.C)."""
    for patch, bc in zip(mesh.patches, p.bcs):
        if pf.is_value_bc(bc) or bc.kind in ("mixed", "inletOutlet", "totalPressure"):
            return False
    return True


def boundary_flux(mesh, U: VolField) -> Any:
    """Sf . U_b on boundary faces (masked on empty patches)."""
    ub = U.boundary_values(mesh)
    nif = mesh.n_internal_faces
    return jnp.sum(mesh.sf[nif:] * ub, axis=1) * mesh.face_active[nif:]


def face_interp_cell(mesh, data: Any) -> Any:
    """Interpolate per-cell scalar data to ALL faces with zero-gradient
    boundary extrapolation (for rAU etc.)."""
    vi = surface.interpolate_internal(mesh, data)
    vb = surface.owner_to_b(mesh, data)
    return jnp.concatenate([vi, vb], axis=0)


def div_weights(mesh, phi: Any, scheme: str, field: VolField = None) -> Any:
    """Owner-side face weights on internal faces per divScheme keyword."""
    from ..ops import schemes

    return schemes.weights(mesh, phi, scheme, field)


def piso_step(mesh, state: Dict, dt: Any, cfg: PisoConfig) -> Tuple[Dict, Dict]:
    """One PISO time step. state: {"U": VolField, "p": VolField,
    "phi": [nF]}. Returns (new_state, diagnostics)."""
    p_ctrl = cfg.p_controls or _default_controls()[0]
    u_ctrl = cfg.u_controls or _default_controls()[1]

    from ..ops import schemes as schemes_mod
    from ..ops import slot as slot_mod

    U: VolField = state["U"]
    p: VolField = state["p"]
    phi = state["phi"]
    nif = mesh.n_internal_faces
    rdt = 1.0 / dt
    diag: Dict[str, Any] = {}

    # slot-form flux (gather-free hot path, ops/slot.py): carried in the
    # state next to the flat flux; derived once if absent
    if "phi_slot" in state:
        phi_slot = slot_mod.SlotFace(*state["phi_slot"], bv=phi[nif:])
    else:
        phi_slot = slot_mod.from_flat(mesh, phi)

    # fan jump pairs re-evaluate their curve at the current flow rate
    # (reference: fan updateCoeffs) — trace-time no-op without fan BCs
    if any(bc.kind == "fan" for bc in p.bcs):
        p = p.correct_boundary_conditions(mesh, phi=phi)

    # -- momentum equation (laminar diffusion or turbulence divDevReff) -------
    w_slot = (None if cfg.div_scheme == "linear" else
              schemes_mod.weights_slot(mesh, phi_slot, cfg.div_scheme, U))
    UEqn = (
        ddt_matrix(mesh, U, state, rdt, cfg.ddt_scheme)
        + fvm.div(mesh, phi, U, phi_slot=phi_slot, slot_weights=w_slot)
    )
    if cfg.turb is not None:
        visc_mat, visc_expl = cfg.turb.div_dev_reff(mesh, state["turb"], U)
        UEqn = UEqn + visc_mat
        UEqn = UEqn.add_source(-visc_expl, mesh)
    elif cfg.nu_fn is not None:
        # non-Newtonian viscosity (reference: nonNewtonianIcoFoam +
        # singlePhaseTransportModel): nu(strainRate) updated each step
        nu_cell = cfg.nu_fn(mesh, U)
        nu_b = surface.owner_to_b(mesh, nu_cell)
        nu_slot = slot_mod.interpolate(mesh, nu_cell, bv=nu_b)
        UEqn = UEqn - fvm.laplacian(
            mesh, slot_mod.to_flat(mesh, nu_slot), U,
            corrected=cfg.corrected, gamma_dims=dimViscosity,
            limit=cfg.corr_limit, gamma_slot=nu_slot)
    else:
        UEqn = UEqn - fvm.laplacian(
            mesh, jnp.asarray(cfg.nu, mesh.v.dtype), U,
            corrected=cfg.corrected, gamma_dims=dimViscosity,
            limit=cfg.corr_limit)
    if cfg.fv_options:
        UEqn = cfg.fv_options.add_to(mesh, UEqn, "U", U, U=U,
                                     fvopt_state=state.get("fvopt"))
    if "mom_src" in state:
        # two-way lagrangian momentum coupling (reference:
        # KinematicCloud::SU(U) in the solver's UEqn). The source must
        # be in the EQUATION's units: this kinematic (rho-less) family
        # takes force/rho_fluid [m^4/s^2] per cell.
        UEqn = UEqn.add_source(state["mom_src"] / mesh.v[:, None], mesh)
    if cfg.mrf:
        # reference: mrfZones.addCoriolis(UEqn())
        UEqn = cfg.mrf.add_coriolis(mesh, UEqn, U)
    grad_p = fvc.grad_of(mesh, p, cfg.grad_scheme)
    if cfg.momentum_predictor:
        Umat = UEqn.add_source(-grad_p, mesh)
        Udata, uperf = linear.solve(mesh, Umat, U.data, u_ctrl)
        U = U.with_data(Udata)
        diag["Ux"] = uperf
    else:
        diag["Ux"] = None

    # -- PISO corrector loop ----------------------------------------------------
    rA = 1.0 / UEqn.A(mesh)
    rA_b = surface.owner_to_b(mesh, rA)
    rAf_slot = slot_mod.interpolate(mesh, rA, bv=rA_b)
    rAf = slot_mod.to_flat(mesh, rAf_slot)   # flat view: GAMG coarsening
    rAf_dims = dimTime
    # the pressure-matrix COEFFICIENTS are identical for every corrector
    # and non-ortho iteration (rAf is fixed once UEqn is assembled) —
    # assemble once and share one GAMG prep across all solves; only the
    # source and the deferred non-ortho correction change per iteration
    use_corr = cfg.corrected and not getattr(mesh, "orthogonal", False)
    pEqn0 = fvm.laplacian(
        mesh, rAf, p, corrected=cfg.corrected, gamma_dims=rAf_dims,
        limit=cfg.corr_limit, defer_correction=True, gamma_slot=rAf_slot,
    )
    ctl_final0 = cfg.p_controls_final or p_ctrl
    p_ctrl_p, ctl_final_p = linear.prepare_controls(
        mesh, pEqn0, p_ctrl, ctl_final0)

    for corr in range(cfg.n_correctors):
        HbyA = rA[:, None] * UEqn.H(mesh, U.data)
        phiHbyA = slot_mod.flux_of(mesh, HbyA, bv=boundary_flux(mesh, U))
        if cfg.mrf:
            # reference: mrfZones.relativeFlux(phiHbyA) before adjustPhi
            phiHbyA = cfg.mrf.make_relative(mesh, phiHbyA)
        phiHbyA_b = phiHbyA.bv
        if needs_reference(p, mesh):
            # global flux balance before the singular pressure solve
            # (reference: adjustPhi(phiHbyA, U, p) in icoFoam/pisoFoam
            # pEqn.H; cfdTools/general/adjustPhi/) — without it an
            # inlet/outlet imbalance makes the all-Neumann RHS
            # inconsistent and mass drifts (ADVICE.md r1 #3).
            from .simple import adjust_phi

            phiHbyA_b = adjust_phi(mesh, phiHbyA_b, U)
            phiHbyA = phiHbyA._replace(bv=phiHbyA_b)

        for nonorth in range(cfg.n_non_orth + 1):
            corr_face = None
            if use_corr:
                corr_face, corr_cell = slot_mod.laplacian_correction(
                    mesh, rAf_slot, p.data, p.boundary_values(mesh),
                    limit=cfg.corr_limit)
                pEqn = pEqn0.replace_fields(
                    source=pEqn0.source - corr_cell
                    + slot_mod.surface_sum(mesh, phiHbyA),
                )
            else:
                pEqn = pEqn0.replace_fields(
                    source=pEqn0.source + slot_mod.surface_sum(mesh, phiHbyA)
                )
            final = (corr == cfg.n_correctors - 1
                     and nonorth == cfg.n_non_orth)
            ctl = ctl_final_p if final else p_ctrl_p
            pEqn, ctl = linear.prep_pressure(
                pEqn, needs_reference(p, mesh), ctl,
                cfg.p_ref_cell, cfg.p_ref_value)
            pdata, pperf = linear.solve(mesh, pEqn, p.data, ctl)
            p = p.with_data(pdata)
            if corr == 0 and nonorth == 0:
                diag["p_initial"] = pperf.initial_residual
                diag["p_iters"] = pperf.n_iterations
            diag["p_final"] = pperf.final_residual
            if nonorth == cfg.n_non_orth:
                # phi = phiHbyA - pEqn.flux (all in slot form; the
                # boundary flux part stays flat and small)
                F = slot_mod.laplacian_flux(
                    mesh, rAf_slot, p.data, corrected=use_corr,
                    corr=corr_face)
                p_bc = surface.owner_to_b(mesh, p.data)
                F_b = pEqn.ic * p_bc - pEqn.bc
                phi_slot = slot_mod.SlotFace(
                    phiHbyA.sv - F.sv, phiHbyA.fb - F.fb, phiHbyA_b - F_b)

        grad_p = fvc.grad_of(mesh, p, cfg.grad_scheme)
        U = U.with_data(HbyA - rA[:, None] * grad_p)
        phi_for_bc = jnp.concatenate(
            [jnp.zeros(nif, phi.dtype), phi_slot.bv], axis=0)
        U = U.correct_boundary_conditions(mesh, phi=phi_for_bc)
    phi = slot_mod.to_flat(mesh, phi_slot)
    fvopt_state = state.get("fvopt")
    if cfg.fv_options:
        # reference: fvOptions.correct(U) after the corrector loop
        U, fvopt_state = cfg.fv_options.correct_U(mesh, U, rA, fvopt_state)

    # -- turbulence correction (pisoFoam: turbulence->correct()) --------------
    new_turb = state.get("turb")
    if cfg.turb is not None:
        new_turb, tdiag = cfg.turb.correct(
            mesh, state["turb"], U, phi, dt, controls=cfg.turb_controls,
            phi_slot=phi_slot)
        diag.update({f"turb_{k}": v for k, v in tdiag.items()})

    # -- diagnostics --------------------------------------------------------------
    div_phi = slot_mod.surface_sum(mesh, phi_slot)  # continuity error * V
    diag["continuity"] = jnp.sum(jnp.abs(div_phi)) / jnp.sum(mesh.v)
    diag["continuity_global"] = jnp.sum(div_phi) / jnp.sum(mesh.v)
    # Courant number: 0.5 * sum|phi| / V * dt
    sum_phi = slot_mod.weighted_cell_sum(mesh, phi_slot, absolute=True)
    diag["courant_max"] = 0.5 * jnp.max(sum_phi / mesh.v) * dt
    diag["courant_mean"] = 0.5 * (
        (jnp.sum(jnp.abs(phi_slot.sv) * mesh.st_valid)
         + jnp.sum(jnp.abs(phi_slot.fb)) + 2.0 * jnp.sum(jnp.abs(phi_slot.bv)))
        / (2.0 * jnp.sum(mesh.v))) * dt

    new_state = dict(state)
    new_state.update(U=U, p=p, phi=phi,
                     phi_slot=(phi_slot.sv, phi_slot.fb))
    if fvopt_state is not None:
        new_state["fvopt"] = fvopt_state
    advance_time_state(state, new_state, U, rdt, cfg.ddt_scheme)
    if new_turb is not None:
        new_state["turb"] = new_turb
    return new_state, diag


def make_step(mesh, cfg: PisoConfig):
    """Returns a jitted (state, dt) -> (state, diag) PISO step. The
    mesh and GAMG hierarchies travel as jit ARGUMENTS (see jitstep)."""
    from .jitstep import jit_with_mesh

    return jit_with_mesh(
        lambda m, state, dt: piso_step(m, state, dt, cfg), mesh,
        (cfg.p_controls, cfg.p_controls_final, cfg.u_controls))


def make_chunk(mesh, cfg: PisoConfig, n: int, unroll: int = None):
    """n PISO steps per device call (lax.scan), fixed dt — one host
    round-trip and one program launch per chunk instead of per step,
    exactly as the SIMPLE chunk does; returns the last step's
    diagnostics.

    unroll (default FOAMTPU_CHUNK_UNROLL=5): scan body unrolling. The
    scan carry forces one layout on every carried array; the step body
    may want another for U, and XLA then relayouts it every iteration.
    Unrolling lets XLA fuse and lay out across steps, at the price of a
    longer compile (amortised by the persistent cache). Not yet
    measured on the GPU."""
    import os as _os

    from .jitstep import jit_with_mesh

    if unroll is None:
        unroll = int(_os.environ.get("FOAMTPU_CHUNK_UNROLL", "5"))
    unroll = max(1, min(unroll, n))

    def chunk(m, state, dt):
        def body(st, _):
            st, diag = piso_step(m, st, dt, cfg)
            return st, diag

        state_out, diags = jax.lax.scan(body, state, None, length=n,
                                        unroll=unroll)
        last = jax.tree_util.tree_map(lambda x: x[-1], diags)
        return state_out, last

    return jit_with_mesh(
        chunk, mesh, (cfg.p_controls, cfg.p_controls_final,
                      cfg.u_controls))


def project_initial_flux(mesh, p: VolField, phi: Any,
                         controls: Optional[Dict] = None) -> Any:
    """Make the initial flux divergence-free by one pressure-style
    projection (a one-shot potentialFoam, reference:
    applications/solvers/basic/potentialFoam). Without this, a case
    initialised with U=0 internally but a fixedValue inlet has inflow
    with no outflow, and the first momentum solve is unbounded (the
    convective source has no convective diagonal)."""
    import dataclasses as _dc

    ctl = dict(controls or {})
    ctl.setdefault("solver", "PCG")
    ctl.setdefault("tolerance", 1e-7)
    ctl.setdefault("relTol", 0.0)
    ctl.setdefault("maxIter", 3000)
    ctl.pop("_gamg", None)  # dims differ from the p-equation hierarchy use

    pcorr = _dc.replace(p, data=jnp.zeros_like(p.data), name="pcorr")
    from ..core.dimensions import dimless

    # scale the problem to O(1): an (almost-)balanced initial flux gives
    # a roundoff-level RHS on which f32 Krylov iteration degenerates
    div0 = surface.surface_sum(mesh, phi)
    scale = jnp.maximum(jnp.max(jnp.abs(div0)), 1e-30)

    eqn = fvm.laplacian(mesh, 1.0, pcorr, corrected=False,
                        gamma_dims=dimless)
    eqn = eqn.replace_fields(source=eqn.source + div0 / scale)
    if needs_reference(pcorr, mesh):
        eqn = eqn.set_reference(0, 0.0)
    data, _ = linear.solve(mesh, eqn, pcorr.data, ctl)
    return phi - eqn.flux(mesh, data) * scale


def initial_state(mesh, U: VolField, p: VolField,
                  turb_state: Optional[Dict] = None,
                  project: bool = True,
                  ddt_scheme: str = "Euler") -> Dict:
    from ..ops import slot as slot_mod

    # ONE jitted program for flux + projection + slot conversion: each
    # eager op compiles and dispatches separately (the n^3 scale cases
    # spent minutes here before this was fused)
    def _initial_flux(Uf):
        phi = fvc.flux(mesh, Uf)
        if project:
            phi = project_initial_flux(mesh, p, phi)
        sl = slot_mod.from_flat(mesh, phi)
        return phi, sl

    phi, phi_sl = jax.jit(_initial_flux)(U)
    st = {"U": U, "p": p, "phi": phi, "U0": U.data,
          "phi_slot": (phi_sl.sv, phi_sl.fb)}
    toks = ddt_scheme.split()
    if toks[0] == "backward":
        # reference: deltaT0_ = GREAT until oldTime.oldTime exists ->
        # the first step degenerates to Euler
        st["U00"] = U.data
        st["rdt0"] = jnp.asarray(1e-30, mesh.v.dtype)
    elif toks[0] == "CrankNicolson":
        st["ddt0_U"] = jnp.zeros_like(U.data)
        st["rdt0"] = jnp.asarray(1e-30, mesh.v.dtype)
    if turb_state is not None:
        st["turb"] = turb_state
    return st
