"""Solver applications: case-driven host loops
(the equivalents of the reference's applications/solvers/ binaries).

Each application reads its config from the case dictionaries, builds
the jitted step, runs the Time loop with reference-format logging, and
writes OpenFOAM-format output at write times.

Implemented: icoFoam, pisoFoam, pimpleFoam, simpleFoam,
scalarTransportFoam, laplacianFoam, potentialFoam
(reference: applications/solvers/{incompressible,basic}/...).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..core import case as case_mod
from ..core.dictionary import FoamDict, dimensioned_scalar, parse_file
from ..models import turbulence as turb_mod
from ..utils import logging as log
from . import piso as piso_mod
from . import simple as simple_mod
from .linear.krylov import SolverPerf


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _load_turbulence(case, nu: float, compressible: bool = False):
    """Read RASProperties/LESProperties, build the model + its field
    state from the start-time directory. compressible=True selects the
    rho-weighted tree (models/turbulence/compressible.py) and `nu` is
    then the molecular DYNAMIC viscosity, as in the reference where
    the namespace comes from the library the solver links."""
    for fname, kind in (("RASProperties", "RAS"), ("LESProperties", "LES"),
                        ("turbulenceProperties", "RAS")):
        path = case.const_path(fname)
        if os.path.exists(path):
            props = parse_file(path)
            break
    else:
        return None, None
    model = turb_mod.select(props, nu, kind=kind,
                            compressible=compressible)
    model.corrected = case.laplacian_corrected()
    model.corr_limit = case.corr_limit()
    try:
        model.div_scheme = case.div_scheme("div(phi,k)")
    except KeyError:
        pass
    if not model.field_names:
        return None, None
    def read_state(model):
        tstate = {}
        optional = getattr(model, "optional_fields", ())
        for name in model.field_names + tuple(
                f for f in optional if f not in model.field_names):
            try:
                tstate[name] = case.read_field(name)
            except (FileNotFoundError, KeyError, OSError):
                if name not in optional:
                    raise
        return tstate

    try:
        tstate = read_state(model)
    except (FileNotFoundError, KeyError, OSError):
        if not getattr(model, "compressible_form", False):
            raise
        # case ships nut-style fields, not 0/mut: fall back to the
        # incompressible twin (the pre-r4 alias path, still correct
        # for near-constant-rho cases)
        model = turb_mod.select(props, nu, kind=kind)
        model.corrected = case.laplacian_corrected()
        model.corr_limit = case.corr_limit()
        try:
            model.div_scheme = case.div_scheme("div(phi,k)")
        except KeyError:
            pass
        if not model.field_names:
            return None, None
        tstate = read_state(model)
    if hasattr(model, "init_wall_distance"):
        model.init_wall_distance(case.poly_mesh, np.asarray(case.mesh.v).dtype)
    return model, tstate


def _load_mrf(case):
    """constant/MRFZones -> models/mrf.MRFZones (or None). When
    constant/SRFProperties exists (SRFSimpleFoam/SRFPimpleFoam), the
    single rotating frame is the MRF machinery applied to the WHOLE
    domain (reference: src/finiteVolume/cfdTools/general/SRF/ — same
    Coriolis + frame-flux terms, selectionMode all)."""
    import os as _os

    from ..core.dictionary import FoamDict as _FD
    from ..models import mrf as mrf_mod

    srf_path = _os.path.join(case.dir, "constant", "SRFProperties")
    if _os.path.exists(srf_path):
        srf = parse_file(srf_path)
        coeffs = srf.get("rpmCoeffs", srf)
        om = coeffs.get("rpm", None)
        if om is not None:
            omega = float(om if not isinstance(om, (list, tuple))
                          else om[-1]) * 2.0 * np.pi / 60.0
        else:
            omega = _dim_scalar_of(srf, "omega", 0.0)
        spec = _FD([("selectionMode", "all"),
                    ("origin", tuple(np.asarray(
                        srf.get("origin", (0.0, 0.0, 0.0)),
                        dtype=float))),
                    ("axis", tuple(np.asarray(
                        srf.get("axis", (0.0, 0.0, 1.0)),
                        dtype=float))),
                    ("omega", omega)])
        nrp = srf.get("nonRotatingPatches")
        if nrp is not None:
            spec["nonRotatingPatches"] = nrp
        return mrf_mod.from_dict(case.mesh, _FD([("SRF", spec)]))
    return mrf_mod.from_case(case)


def _load_fvoptions(case, nu: float):
    """system/fvOptions -> OptionList (reference: fv::optionList
    constructed by every solver; None when the file is absent)."""
    from ..models import fvoptions as fvopt_mod

    return fvopt_mod.from_case(case, nu)


def _relaxation(case) -> Dict[str, float]:
    out: Dict[str, float] = {}
    rf = case.fv_solution.get("relaxationFactors")
    if isinstance(rf, FoamDict):
        for sub in ("fields", "equations"):
            if sub in rf and isinstance(rf[sub], FoamDict):
                for k, v in rf[sub].items():
                    out[str(k)] = float(v)
        for k, v in rf.items():
            if not isinstance(v, FoamDict):
                out[str(k)] = float(v)
    return out


def _residual_control(case, name="SIMPLE") -> Dict[str, float]:
    d = case.pimple_controls(name).get("residualControl")
    if isinstance(d, FoamDict):
        return {str(k): float(v) for k, v in d.items()
                if isinstance(v, (int, float))}
    return {}


def _log_step(case, t, diag, cumulative, extra_fields=()):
    log.info(f"Time = {t.name}\n")
    if "courant_mean" in diag:
        log.info(log.courant_line(float(diag["courant_mean"]),
                                  float(diag["courant_max"])))
    if diag.get("Ux") is not None:
        log.info(log.solver_line("U", diag["Ux"]))
    if "p_initial" in diag:
        log.info(log.solver_line("p", SolverPerf(
            diag["p_initial"], diag["p_final"], diag["p_iters"])))
    for name in extra_fields:
        perf = diag.get(f"turb_{name}")
        if perf is not None:
            log.info(log.solver_line(name, perf))
    if "continuity" in diag:
        dtv = getattr(t, "current_dt", 1.0)
        local = float(diag["continuity"]) * dtv
        glob = float(diag.get("continuity_global", 0.0)) * dtv
        cumulative += glob
        log.info(log.continuity_line(local, glob, cumulative))
    log.info(f"ExecutionTime = {t.execution_time():.2f} s"
             f"  ClockTime = {t.clock_time():.0f} s\n")
    # runTimeModifiable: pick up controlDict edits between chunks
    if t.read_if_modified():
        log.info("regIOobject::readIfModified() : "
                 "Re-reading object controlDict\n")
    return cumulative


def _write_state(case, state):
    fields = [state["U"], state["p"]]
    if "turb" in state and state["turb"]:
        fields += list(state["turb"].values())
    case.write_fields(fields)


# ---------------------------------------------------------------------------
# transient PISO family
# ---------------------------------------------------------------------------


def _run_piso(case, max_steps, with_turbulence: bool,
              control_name: str = "PISO", nu_fn=None) -> None:
    mesh = case.mesh
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])

    U = case.read_field("U")
    p = case.read_field("p")
    mrf = _load_mrf(case)
    if mrf:
        U = mrf.correct_boundary_velocity(mesh, U)
    model = tstate = None
    if with_turbulence:
        model, tstate = _load_turbulence(case, nu)

    pdict = case.pimple_controls(control_name)
    turb_ctl = None
    try:
        turb_ctl = case.solver_controls("k")
    except KeyError:
        pass
    cfg = piso_mod.PisoConfig(
        nu=nu,
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        momentum_predictor=str(pdict.get("momentumPredictor", "yes")) in (
            "yes", "true", "on", "1"),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        ddt_scheme=case.ddt_scheme(),
        grad_scheme=case.grad_scheme("grad(p)"),
        p_ref_cell=int(pdict.get("pRefCell", 0)),
        p_ref_value=float(pdict.get("pRefValue", 0.0)),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        turb=model,
        turb_controls=turb_ctl,
        nu_fn=nu_fn,
        fv_options=_load_fvoptions(case, nu),
        mrf=mrf,
    )
    step = piso_mod.make_step(mesh, cfg)
    state = piso_mod.initial_state(mesh, U, p, turb_state=tstate,
                                   ddt_scheme=cfg.ddt_scheme)
    if mrf:
        from ..models import mrf as mrf_mod

        state = mrf_mod.make_relative_state(mesh, mrf, state)
    if cfg.fv_options:
        state["fvopt"] = cfg.fv_options.init_state(mesh)

    from ..functionobjects import make_function_objects

    fol = make_function_objects(case)
    extra = model.field_names[:-1] if model else ()
    log.info(f"Starting time loop: {case.application}, {mesh.n_cells} cells\n")
    cumulative = 0.0
    for t in case.time.loop():
        dt = jnp.asarray(t.current_dt, mesh.v.dtype)
        state, diag = step(state, dt)
        cumulative = _log_step(case, t, diag, cumulative, extra)
        fol.execute(t.name, state)
        t.adjust_delta_t(float(diag["courant_max"]))
        if t.write_time():
            _write_state(case, state)
            log.info(f"Writing fields at time {t.name}\n")
        if max_steps is not None and t.index >= max_steps:
            break
    _write_state(case, state)
    log.info("End\n")
    case.final_state = state


def icofoam(case, max_steps: Optional[int] = None) -> None:
    """icoFoam (reference: incompressible/icoFoam/icoFoam.C)."""
    _run_piso(case, max_steps, with_turbulence=False, control_name="PISO")


def non_newtonian_icofoam(case, max_steps: Optional[int] = None) -> None:
    """nonNewtonianIcoFoam (reference:
    incompressible/nonNewtonianIcoFoam/) — icoFoam with a
    strain-rate-dependent viscosity model selected from
    transportProperties."""
    from ..models import transport as transport_mod

    props = case.transport_properties()
    nu_model = transport_mod.select(props)

    def nu_fn(mesh, U):
        return nu_model(mesh, U)

    _run_piso(case, max_steps, with_turbulence=False, control_name="PISO",
              nu_fn=nu_fn)


def pisofoam(case, max_steps: Optional[int] = None) -> None:
    """pisoFoam: PISO + turbulence model
    (reference: incompressible/pisoFoam/pisoFoam.C)."""
    _run_piso(case, max_steps, with_turbulence=True, control_name="PISO")


def pimplefoam(case, max_steps: Optional[int] = None) -> None:
    """pimpleFoam: merged PISO-SIMPLE with nOuterCorrectors outer
    iterations, inter-iteration relaxation, and final-iteration
    semantics (reference: incompressible/pimpleFoam/pimpleFoam.C +
    pimpleControl). nOuterCorrectors=1 reduces to PISO."""
    from . import pimple as pimple_mod

    mesh = case.mesh
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    U = case.read_field("U")
    p = case.read_field("p")
    mrf = _load_mrf(case)
    if mrf:
        U = mrf.correct_boundary_velocity(mesh, U)
    model, tstate = _load_turbulence(case, nu)

    pdict = case.pimple_controls("PIMPLE")
    relax = _relaxation(case)
    turb_ctl = None
    try:
        turb_ctl = case.solver_controls("k")
    except KeyError:
        pass
    try:
        p_final = case.solver_controls("pFinal")
    except KeyError:
        p_final = None
    cfg = pimple_mod.PimpleConfig(
        nu=nu,
        n_outer=int(pdict.get("nOuterCorrectors", 1)),
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        momentum_predictor=str(pdict.get("momentumPredictor", "yes")) in (
            "yes", "true", "on", "1"),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        ddt_scheme=case.ddt_scheme(),
        grad_scheme=case.grad_scheme("grad(p)"),
        p_ref_cell=int(pdict.get("pRefCell", 0)),
        p_ref_value=float(pdict.get("pRefValue", 0.0)),
        alpha_u=relax.get("U", 1.0),
        alpha_p=relax.get("p", 1.0),
        p_controls=case.solver_controls("p"),
        p_controls_final=p_final,
        u_controls=case.solver_controls("U"),
        turb=model,
        turb_controls=turb_ctl,
        turb_on_final_only=str(pdict.get("turbOnFinalIterOnly", "yes")) in (
            "yes", "true", "on", "1"),
        fv_options=_load_fvoptions(case, nu),
        mrf=mrf,
    )
    step = pimple_mod.make_step(mesh, cfg)
    state = piso_mod.initial_state(mesh, U, p, turb_state=tstate,
                                   ddt_scheme=cfg.ddt_scheme)
    if mrf:
        from ..models import mrf as mrf_mod

        state = mrf_mod.make_relative_state(mesh, mrf, state)
    if cfg.fv_options:
        state["fvopt"] = cfg.fv_options.init_state(mesh)

    from ..functionobjects import make_function_objects

    fol = make_function_objects(case)
    extra = model.field_names[:-1] if model else ()
    log.info(f"Starting time loop: pimpleFoam, {mesh.n_cells} cells\n")
    cumulative = 0.0
    for t in case.time.loop():
        dt = jnp.asarray(t.current_dt, mesh.v.dtype)
        state, diag = step(state, dt)
        cumulative = _log_step(case, t, diag, cumulative, extra)
        fol.execute(t.name, state)
        t.adjust_delta_t(float(diag["courant_max"]))
        if t.write_time():
            _write_state(case, state)
            log.info(f"Writing fields at time {t.name}\n")
        if max_steps is not None and t.index >= max_steps:
            break
    _write_state(case, state)
    log.info("End\n")
    case.final_state = state


# ---------------------------------------------------------------------------
# steady SIMPLE
# ---------------------------------------------------------------------------


def simplefoam(case, max_steps: Optional[int] = None) -> None:
    """simpleFoam (reference: incompressible/simpleFoam/)."""
    mesh = case.mesh
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    U = case.read_field("U")
    p = case.read_field("p")
    mrf = _load_mrf(case)
    if mrf:
        U = mrf.correct_boundary_velocity(mesh, U)
    model, tstate = _load_turbulence(case, nu)

    sdict = case.pimple_controls("SIMPLE")
    relax = _relaxation(case)
    turb_ctl = None
    try:
        turb_ctl = case.solver_controls("k")
    except KeyError:
        pass
    cfg = simple_mod.SimpleConfig(
        nu=nu,
        n_non_orth=int(sdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        grad_scheme=case.grad_scheme("grad(p)"),
        p_ref_cell=int(sdict.get("pRefCell", 0)),
        p_ref_value=float(sdict.get("pRefValue", 0.0)),
        alpha_u=relax.get("U", 0.7),
        alpha_p=relax.get("p", 0.3),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        turb=model,
        turb_controls=turb_ctl,
        turb_relax=relax.get("k", relax.get("epsilon", 0.7)),
        fv_options=_load_fvoptions(case, nu),
        mrf=mrf,
    )
    # chunked stepping: one host round-trip per `chunk` iterations
    chunk_n = int(os.environ.get("FOAMTPU_CHUNK", "10"))
    chunk = simple_mod.make_chunk(mesh, cfg, chunk_n)
    state = piso_mod.initial_state(mesh, U, p, turb_state=tstate)
    if mrf:
        from ..models import mrf as mrf_mod

        state = mrf_mod.make_relative_state(mesh, mrf, state)
    if cfg.fv_options:
        state["fvopt"] = cfg.fv_options.init_state(mesh)
    res_ctl = _residual_control(case, "SIMPLE")

    extra = model.field_names[:-1] if model else ()
    log.info(f"Starting SIMPLE loop: simpleFoam, {mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    from ..functionobjects import make_function_objects

    fol = make_function_objects(case)
    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = chunk(state)
        t.index += chunk_n
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = t.delta_t
        cumulative = _log_step(case, t, diag, cumulative, extra)
        fol.execute(t.name, state)
        if t.write_time():
            _write_state(case, state)
        if simple_mod.converged(diag, res_ctl):
            log.info(f"SIMPLE solution converged in {t.index} iterations\n")
            break
    _write_state(case, state)
    log.info("End\n")
    case.final_state = state


# ---------------------------------------------------------------------------
# basic solvers
# ---------------------------------------------------------------------------


def scalar_transport_foam(case, max_steps: Optional[int] = None) -> None:
    """scalarTransportFoam: passive scalar advection-diffusion
    (reference: basic/scalarTransportFoam/)."""
    import jax

    from ..core.dimensions import dimViscosity
    from ..ops import fvc, fvm
    from . import linear

    mesh = case.mesh
    tp = case.transport_properties()
    _, DT = dimensioned_scalar(tp["DT"])
    U = case.read_field("U")
    T = case.read_field("T")
    phi = fvc.flux(mesh, U)
    ctl = case.solver_controls("T")
    scheme = case.div_scheme("div(phi,T)")

    @jax.jit
    def step(T_field, dt):
        rdt = 1.0 / dt
        from .piso import div_weights

        w = div_weights(mesh, phi, scheme, T_field)
        eqn = (fvm.ddt(mesh, T_field, T_field.data, rdt)
               + fvm.div(mesh, phi, T_field, weights=w)
               - fvm.laplacian(mesh, jnp.asarray(DT, mesh.v.dtype), T_field,
                               corrected=case.laplacian_corrected(),
                               gamma_dims=dimViscosity))
        data, perf = linear.solve(mesh, eqn, T_field.data, ctl)
        return T_field.with_data(data), perf

    for t in case.time.loop():
        T, perf = step(T, jnp.asarray(t.current_dt, mesh.v.dtype))
        log.info(f"Time = {t.name}")
        log.info(log.solver_line("T", perf))
        if t.write_time():
            case.write_fields([T])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([T])
    case.final_state = {"T": T}
    log.info("End\n")


def laplacian_foam(case, max_steps: Optional[int] = None) -> None:
    """laplacianFoam: transient diffusion of T
    (reference: basic/laplacianFoam/)."""
    import jax

    from ..core.dimensions import dimViscosity
    from ..ops import fvm
    from . import linear

    mesh = case.mesh
    tp = case.transport_properties()
    _, DT = dimensioned_scalar(tp["DT"])
    T = case.read_field("T")
    ctl = case.solver_controls("T")

    @jax.jit
    def step(T_field, dt):
        rdt = 1.0 / dt
        eqn = (fvm.ddt(mesh, T_field, T_field.data, rdt)
               - fvm.laplacian(mesh, jnp.asarray(DT, mesh.v.dtype), T_field,
                               corrected=case.laplacian_corrected(),
                               gamma_dims=dimViscosity))
        data, perf = linear.solve(mesh, eqn, T_field.data, ctl)
        return T_field.with_data(data), perf

    for t in case.time.loop():
        T, perf = step(T, jnp.asarray(t.current_dt, mesh.v.dtype))
        log.info(f"Time = {t.name}")
        log.info(log.solver_line("T", perf))
        if t.write_time():
            case.write_fields([T])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([T])
    case.final_state = {"T": T}
    log.info("End\n")


def chem_foam(case, max_steps: Optional[int] = None) -> None:
    """chemFoam: single-cell (0-D) chemistry reactor (reference:
    applications/solvers/combustion/chemFoam/). Mechanism from
    constant/reactions (+ thermo.compressibleGas); initial state from
    constant/initialConditions {p; T; fractions {..};}. Integrates the
    stiff system with the vmapped Rosenbrock solver at CONSTANT VOLUME
    (constantProperty volume — the pressure branch is approximated the
    same way; documented) and logs T each step."""
    import jax

    from ..models import chemistry as chem_mod

    rx = case.properties("reactions")
    try:
        thd = case.properties("thermo.compressibleGas")
    except Exception:
        thd = None
    chem, W = chem_mod.from_foam_files(rx, thd)
    species = list(chem.species)
    ic = case.properties("initialConditions")
    p0 = _dim_scalar_of(ic, "p", 1e5)
    T0 = _dim_scalar_of(ic, "T", 1000.0)
    fr = ic.get("fractions", FoamDict())
    Y = np.zeros(len(species))
    for i, s in enumerate(species):
        Y[i] = float(fr.get(s, 0.0))
    Y = Y / max(Y.sum(), 1e-300)
    Wmix = 1.0 / float((Y / W).sum())
    R = 8314.47 / Wmix
    rho = p0 / (R * T0)
    # mean Cv from janaf at T0 when available, else air-like
    cv = 718.0
    if thd is not None:
        try:
            from ..models.thermo import _janaf_from_mixture

            cps = []
            for i, s in enumerate(species):
                if s in thd and Y[i] > 0:
                    g = _janaf_from_mixture(thd[s])
                    cps.append(float(Y[i]) * float(np.asarray(
                        g.Cp_of(jnp.asarray(float(T0))))))
            if cps:
                cp = sum(cps) / Y[Y > 0].sum()
                cv = cp - R
        except Exception:
            pass

    c0 = rho * Y / np.asarray(W)        # kmol/m^3
    c = jnp.asarray(c0[None, :], jnp.float32)
    T = jnp.asarray([T0], jnp.float32)

    @jax.jit
    def step(c, T, dt):
        c_new = chem.solve(c, T, dt, rtol=1e-5)
        q = -(c_new - c) @ chem.hf          # J/m^3 released
        T_new = T + q / (rho * cv)
        return c_new, T_new

    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, jnp.float32)
    log.info(f"Starting loop: chemFoam, {len(species)} species, "
             f"{chem.A.shape[0]} reaction(s)\n")
    while t.index < max_iter and not t.stop_now:
        c, T = step(c, T, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        log.info(f"Time = {t.name}  T = {float(T[0]):.2f}\n")
    Yf = np.asarray(c[0]) * np.asarray(W) / rho
    case.final_state = {"T": float(T[0]), "Y": Yf,
                        "species": species, "p": float(rho * R
                                                       * float(T[0]))}
    log.info("End\n")


def cavitating_foam(case, max_steps: Optional[int] = None,
                    sonic_liquid: bool = False) -> None:
    """cavitatingFoam: barotropic homogeneous-equilibrium cavitation
    (reference: applications/solvers/multiphase/cavitatingFoam/).
    constant/thermodynamicProperties: psil/psiv/rhol0/pSat;
    constant/transportProperties: nul (phase viscosities optional).

    sonic_liquid: sonicLiquidFoam mode (reference: applications/
    solvers/compressible/sonicLiquidFoam/) — the single-phase limit:
    rho = rho0 + psi (p - p0), i.e. rhol0 := rho0 - psi p0 with the
    saturation pressure pushed to -inf so no vapour ever forms."""
    from . import cavitating as cav_mod

    mesh = case.mesh
    th = case.properties("thermodynamicProperties")
    tp = case.transport_properties()
    cdict = case.pimple_controls("PIMPLE")
    if sonic_liquid:
        rho0_l = _dim_scalar_of(th, "rho0", 1000.0)
        p0_l = _dim_scalar_of(th, "p0", 1e5)
        psi_l = _dim_scalar_of(th, "psi", 4.54e-7)
        mu_l = _dim_scalar_of(tp, "mu", 1e-3)
        nu_l = _dim_scalar_of(tp, "nu", mu_l / max(rho0_l, 1e-12))
        cfg = cav_mod.CavitatingConfig(
            rhol0=rho0_l - psi_l * p0_l,
            psil=psi_l, psiv=psi_l,
            p_sat=-1e8,            # never cavitates
            rho_min=1e-3,
            nul=nu_l, nuv=nu_l,
            n_outer=int(cdict.get("nOuterCorrectors", 1)),
            n_correctors=int(cdict.get("nCorrectors", 2)),
            n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
            corrected=case.laplacian_corrected(),
            p_controls=case.solver_controls("p"),
            u_controls=case.solver_controls("U"))
    else:
        cfg = cav_mod.CavitatingConfig(
            rhol0=_dim_scalar_of(th, "rhol0", 1000.0),
            psil=_dim_scalar_of(th, "psil", 4.54e-7),
            psiv=_dim_scalar_of(th, "psiv", 2.5e-6),
            p_sat=_dim_scalar_of(th, "pSat", 2300.0),
            rho_min=_dim_scalar_of(th, "rhoMin", 0.001),
            nul=_dim_scalar_of(tp, "nul", _dim_scalar_of(tp, "nu", 1e-6)),
            nuv=_dim_scalar_of(tp, "nuv", 4.273e-7),
            n_outer=int(cdict.get("nOuterCorrectors", 2)),
            n_correctors=int(cdict.get("nCorrectors", 2)),
            n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
            corrected=case.laplacian_corrected(),
            p_controls=case.solver_controls("p"),
            u_controls=case.solver_controls("U"))
    U = case.read_field("U")
    p = case.read_field("p")
    state = cav_mod.initial_state(mesh, U, p, cfg)
    step = cav_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: cavitatingFoam, {mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)

    def write(state):
        case.write_fields([state["U"], state["p"]])

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        log.info(f"Time = {t.name}\n")
        log.info(f"max(gamma) = {float(diag['gamma_max']):.6g}\n")
        cumulative = _log_step(case, t, diag, cumulative)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def mhd_foam(case, max_steps: Optional[int] = None) -> None:
    """mhdFoam: incompressible MHD (reference: applications/solvers/
    electromagnetics/mhdFoam/). Properties from
    constant/transportProperties: nu, rho, mu (magnetic permeability),
    sigma (conductivity); fields U, p, B (Alfven-velocity units), pB."""
    from . import mhd as mhd_mod

    mesh = case.mesh
    tp = case.transport_properties()
    cdict = case.pimple_controls("PISO")
    cfg = mhd_mod.MhdConfig(
        nu=_dim_scalar_of(tp, "nu", 1e-6),
        rho=_dim_scalar_of(tp, "rho", 1.0),
        mu_mag=_dim_scalar_of(tp, "mu", 1.0),
        sigma_c=_dim_scalar_of(tp, "sigma", 1.0),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        pb_controls=case.solver_controls("pB")
        if _has_solver(case, "pB") else None)
    U = case.read_field("U")
    p = case.read_field("p")
    B = case.read_field("B")
    pB = case.read_field("pB")
    state = mhd_mod.initial_state(mesh, U, p, B, pB)
    step = mhd_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: mhdFoam, {mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)

    def write(state):
        case.write_fields([state["U"], state["p"], state["B"],
                           state["pB"]])

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        log.info(log.solver_line("Bx", diag["Bx"]))
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def financial_foam(case, max_steps: Optional[int] = None) -> None:
    """financialFoam: Black-Scholes option pricing on a 1-D
    stock-price mesh (reference: applications/solvers/financial/
    financialFoam/ — the framework-is-a-general-PDE-toolkit solver):

        ddt(V) + 0.5 sigma^2 S^2 d2V/dS2 + r S dV/dS - r V = 0

    marched backwards from expiry (tau = T - t), with S = the mesh x
    coordinate. constant/financialProperties: sigma, r (both plain or
    dimensioned)."""
    import jax

    from ..core.dimensions import dimViscosity
    from ..ops import fvm
    from . import linear

    mesh = case.mesh
    fp = case.properties("financialProperties")
    sigma = _dim_scalar_of(fp, "sigma", 0.2)
    r = _dim_scalar_of(fp, "r", 0.05)
    V = case.read_field("V")
    ctl = case.solver_controls("V")
    Sf = mesh.cf[:, 0]
    # conservative-form rewrite: div(0.5 s^2 S^2 grad V) =
    # 0.5 s^2 S^2 V'' + s^2 S V', so the drift/sink coefficients are
    # shifted to keep the non-conservative Black-Scholes operator:
    #   drift (r - s^2) S, sink (2r - s^2) V
    gamma_f = 0.5 * sigma * sigma * Sf * Sf
    phi = (r - sigma * sigma) * Sf * mesh.sf[:, 0] * mesh.face_active

    @jax.jit
    def step(V_field, dt):
        rdt = 1.0 / dt
        # in tau the equation reads dV/dtau = 0.5 s^2 S^2 V'' + rSV' - rV
        eqn = (fvm.ddt(mesh, V_field, V_field.data, rdt)
               - fvm.laplacian(mesh, gamma_f, V_field, corrected=False,
                               gamma_dims=dimViscosity)
               - fvm.div(mesh, phi, V_field)
               + fvm.Sp(mesh, jnp.full(mesh.n_cells,
                                       2.0 * r - sigma * sigma,
                                       mesh.v.dtype), V_field))
        data, perf = linear.solve(mesh, eqn, V_field.data, ctl)
        return V_field.with_data(data), perf

    for t in case.time.loop():
        V, perf = step(V, jnp.asarray(t.current_dt, mesh.v.dtype))
        log.info(f"Time = {t.name}")
        log.info(log.solver_line("V", perf))
        if t.write_time():
            case.write_fields([V])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([V])
    case.final_state = {"V": V}
    log.info("End\n")


def electrostatic_foam(case, max_steps: Optional[int] = None) -> None:
    """electrostaticFoam (reference: applications/solvers/
    electromagnetics/electrostaticFoam/): Poisson equation for the
    electric potential + space-charge transport by drift:

        laplacian(phi) == rho/epsilon0
        rhoFlux = -k * magSf * snGrad(phi)
        ddt(rho) + div(rhoFlux, rho) = 0
    """
    import jax

    from ..core.dimensions import dimless
    from ..ops import fvc, fvm
    from . import linear

    mesh = case.mesh
    pp = case.properties("physicalProperties")
    eps0 = _dim_scalar_of(pp, "epsilon0", 8.85418782e-12)
    k_mob = _dim_scalar_of(pp, "k", 1.9e-9)
    phiE = case.read_field("phi")   # electric potential (reference name)
    rho = case.read_field("rho")    # space charge density
    phi_ctl = case.solver_controls("phi")
    rho_ctl = case.solver_controls("rho")

    @jax.jit
    def step(phiE, rho, dt):
        rdt = 1.0 / dt
        eqn = fvm.laplacian(mesh, 1.0, phiE,
                            corrected=case.laplacian_corrected(),
                            gamma_dims=dimless)
        eqn = eqn.add_source(rho.data / eps0, mesh)
        data, pperf = linear.solve(mesh, eqn, phiE.data, phi_ctl)
        phiE = phiE.with_data(data)
        # drift flux on faces
        sng = fvc.sn_grad(mesh, phiE)
        rho_flux = -k_mob * mesh.mag_sf * sng * mesh.face_active
        from .piso import div_weights

        w = div_weights(mesh, rho_flux, "upwind", rho)
        req = (fvm.ddt(mesh, rho, rho.data, rdt)
               + fvm.div(mesh, rho_flux, rho, weights=w,
                         phi_dims=DimensionSet.of(0, 3, -1)))
        rdata, rperf = linear.solve(mesh, req, rho.data, rho_ctl)
        return phiE, rho.with_data(rdata), pperf, rperf

    from ..core.dimensions import DimensionSet

    for t in case.time.loop():
        phiE, rho, pperf, rperf = step(
            phiE, rho, jnp.asarray(t.current_dt, mesh.v.dtype))
        log.info(f"Time = {t.name}")
        log.info(log.solver_line("phi", pperf))
        log.info(log.solver_line("rho", rperf))
        if t.write_time():
            case.write_fields([phiE, rho])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([phiE, rho])
    case.final_state = {"phi": phiE, "rho": rho}
    log.info("End\n")


def magnetic_foam(case, max_steps: Optional[int] = None) -> None:
    """magneticFoam (reference: applications/solvers/electromagnetics/
    magneticFoam/): magnetostatics via the scalar potential psi,

        laplacian(murf, psi) == div(murf * M . Sf)
        H = grad(psi) - M_contribution,  B = mu0 (mur H + M)

    constant/transportProperties `magnets` is a list of dicts
    { box (  (x0 y0 z0) (x1 y1 z1) ); mur <f>; Mr <f>;
      orientation (ox oy oz); } — box selection replaces the
    reference's cellZone names (this mesh layer has no cellZones;
    documented deviation)."""
    import jax

    from ..core.dimensions import dimless
    from ..ops import fvc, fvm, slot as slot_mod, surface
    from . import linear

    mesh = case.mesh
    tp = case.transport_properties()
    mu0 = 4.0e-7 * np.pi
    mur = np.ones(mesh.n_cells)
    M = np.zeros((mesh.n_cells, 3))
    c = np.asarray(mesh.c)
    mags = tp.get("magnets", [])
    # list form `( magnet1 { ... } ... )` parses as alternating
    # name-Word / body-dict items — keep only the bodies
    entries = (list(mags.values()) if isinstance(mags, FoamDict)
               else [e for e in list(mags) if hasattr(e, "get")])
    for spec in entries:
        box = np.asarray(spec.get("box")).reshape(2, 3)
        inside = np.all((c >= box[0]) & (c <= box[1]), axis=1)
        ori = np.asarray(spec.get("orientation", (0.0, 0.0, 1.0)),
                         dtype=float).reshape(3)
        ori = ori / max(np.linalg.norm(ori), 1e-30)
        mur[inside] = float(spec.get("mur", 1.0))
        M[inside] = float(spec.get("Mr", 0.0)) * ori
    mur_j = jnp.asarray(mur, mesh.v.dtype)
    M_j = jnp.asarray(M, mesh.v.dtype)
    psi = case.read_field("psi")
    psi_ctl = case.solver_controls("psi")
    n_non_orth = int(case.pimple_controls("SIMPLE").get(
        "nNonOrthogonalCorrectors", 0))

    @jax.jit
    def solve_psi(psi):
        mur_slot = slot_mod.interpolate(mesh, mur_j,
                                        bv=surface.owner_to_b(mesh, mur_j))
        # div(murf * M_f . Sf): the remanence source. Magnets are
        # interior bodies, so the boundary remanence flux is zero
        # (M = 0 in the surrounding medium at the domain boundary).
        nbf = mesh.n_faces - mesh.n_internal_faces
        m_flux = slot_mod.flux_of(mesh, M_j,
                                  bv=jnp.zeros(nbf, mesh.v.dtype))
        mflux = slot_mod.SlotFace(mur_slot.sv * m_flux.sv,
                                  mur_slot.fb * m_flux.fb, m_flux.bv)
        src = slot_mod.surface_sum(mesh, mflux)    # [nC] integrated
        eqn = fvm.laplacian(mesh, slot_mod.to_flat(mesh, mur_slot), psi,
                            corrected=case.laplacian_corrected(),
                            gamma_dims=dimless, gamma_slot=mur_slot)
        eqn = eqn.replace_fields(source=eqn.source + src)
        from .piso import needs_reference

        eqn, ctl = linear.prep_pressure(eqn, needs_reference(psi, mesh),
                                        dict(psi_ctl), 0, 0.0)
        data, perf = linear.solve(mesh, eqn, psi.data, ctl)
        psi = psi.with_data(data).correct_boundary_conditions(mesh)
        # H = -grad(psi): laplacian(mur, psi) == div(M) comes from
        # div(B) = 0 with B = mu0 (mur H + M) and H = -grad(psi)
        H = -fvc.grad(mesh, psi)
        B = mu0 * (mur_j[:, None] * H + M_j)
        return psi, H, B, perf

    for _ in range(max(n_non_orth, 0) + 1):
        psi, H, B, perf = solve_psi(psi)
        log.info(log.solver_line("psi", perf))
    case.write_fields([psi])
    case.final_state = {"psi": psi, "H": H, "B": B}
    log.info(f"max|B| = {float(jnp.max(jnp.linalg.norm(B, axis=1))):.6g}\n")
    log.info("End\n")


def boundary_foam(case, max_steps: Optional[int] = None) -> None:
    """boundaryFoam (reference: applications/solvers/incompressible/
    boundaryFoam/): steady 1D fully-developed channel/boundary-layer
    flow — momentum diffusion only (no convection), with the axial
    pressure gradient adjusted every iteration to hold the prescribed
    bulk velocity Ubar, and the turbulence model driven by the 1D
    profile. Used to generate inlet profiles and validate wall
    functions."""
    import jax

    from ..core.dimensions import dimViscosity
    from ..ops import fvm
    from . import linear

    mesh = case.mesh
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    ubar_e = tp.get("Ubar")
    ub = np.asarray([float(x) for x in ubar_e[-1]]) \
        if isinstance(ubar_e, list) and isinstance(ubar_e[-1], list) \
        else np.asarray([1.0, 0.0, 0.0])
    mag_ub = float(np.linalg.norm(ub))
    fdir = ub / max(mag_ub, 1e-30)
    model, tstate = _load_turbulence(case, nu)
    U = case.read_field("U")
    u_ctl = case.solver_controls("U")
    alpha_u = _relaxation(case).get("U", 0.5)
    flow_dir = jnp.asarray(fdir, mesh.v.dtype)
    phi0 = jnp.zeros(mesh.n_faces, mesh.v.dtype)
    vtot = jnp.sum(mesh.v)

    def one(U, tstate, gradP):
        if model is not None:
            visc_mat, visc_expl = model.div_dev_reff(mesh, tstate, U)
            UEqn = visc_mat
            UEqn = UEqn.add_source(-visc_expl, mesh)
        else:
            UEqn = -fvm.laplacian(mesh, jnp.asarray(nu, mesh.v.dtype), U,
                                  gamma_dims=dimViscosity)
        # UEqn.relax() (reference boundaryFoam.C) — the implicit
        # under-relaxation is what makes the gradP fixed-point stable:
        # the unrelaxed diffusion matrix responds to gradP with gain
        # h^2/(12 nu rAU_local) >> 1 and the adjustment oscillates
        UEqn = UEqn.relax(mesh, alpha_u, U.data)
        Umat = UEqn.add_source(
            jnp.broadcast_to(gradP * flow_dir, U.data.shape), mesh)
        data, perf = linear.solve(mesh, Umat, U.data, u_ctl)
        U = U.with_data(data)
        # adjust gradP to hold Ubar (reference: boundaryFoam.C)
        rAU = 1.0 / UEqn.A(mesh)
        magUbarStar = jnp.sum(mesh.v * (U.data @ flow_dir)) / vtot
        rAUw = jnp.sum(mesh.v * rAU) / vtot
        dG = (mag_ub - magUbarStar) / rAUw
        U = U.with_data(U.data + (rAU * dG)[:, None] * flow_dir[None, :])
        gradP = gradP + dG
        if model is not None:
            dt1 = jnp.asarray(1.0, mesh.v.dtype)
            tstate, tdiag = model.correct(mesh, tstate, U, phi0, dt1,
                                          steady=True)
        else:
            tdiag = {}
        return U, tstate, gradP, perf, tdiag

    step = jax.jit(one)
    gradP = jnp.zeros((), mesh.v.dtype)
    n_iter = max_steps or int(round(
        (case.time.end_time - case.time.start_time) / case.time.delta_t))
    log.info(f"Starting loop: boundaryFoam, {mesh.n_cells} cells\n")
    for t in case.time.loop():
        U, tstate, gradP, perf, tdiag = step(U, tstate, gradP)
        log.info(f"Time = {t.name}")
        log.info(log.solver_line("Ux", perf))
        log.info(f"Uncorrected Ubar = ..., pressure gradient = "
                 f"{float(gradP):.6g}\n")
        if t.write_time():
            fields = [U] + (list(tstate.values()) if tstate else [])
            case.write_fields(fields)
        if max_steps is not None and t.index >= max_steps:
            break
    fields = [U] + (list(tstate.values()) if tstate else [])
    case.write_fields(fields)
    case.final_state = {"U": U, "turb": tstate, "gradP": gradP}
    log.info("End\n")


def potential_foam(case, max_steps: Optional[int] = None) -> None:
    """potentialFoam: potential-flow initialisation — solve
    laplacian(Phi) = div(phiHbyA-like flux) once, derive U
    (reference: basic/potentialFoam/)."""
    import jax

    from ..core.dimensions import dimless
    from ..core.fields import vol_scalar
    from ..ops import fvc, fvm, surface
    from . import linear
    from .piso import boundary_flux

    mesh = case.mesh
    U = case.read_field("U")
    p = case.read_field("p")
    # velocity potential with p's BC types (zeroGradient walls,
    # fixedValue where p fixed)
    Phi = vol_scalar(mesh, 0.0, name="Phi", bcs=p.bcs)
    ctl = case.solver_controls("p")
    nno = int(case.pimple_controls("potentialFlow").get(
        "nNonOrthogonalCorrectors", 3))

    phi_b = boundary_flux(mesh, U)
    nif = mesh.n_internal_faces
    phi0 = jnp.concatenate([jnp.zeros(nif, mesh.v.dtype), phi_b])

    @jax.jit
    def solve_phi(Phi_field):
        """reference potentialFoam.C: the RHS stays div(phi0) for
        every non-orthogonal iteration (the loop refines only the
        corrected-laplacian coefficients); phi -= PhiEqn.flux() ONCE
        after the loop. (r2 fix: feeding the updated — already
        divergence-free — flux back into the RHS collapsed Phi to
        zero on the second iteration.)"""
        from .piso import needs_reference

        perf = None
        src0 = surface.surface_sum(mesh, phi0)
        corrected = case.laplacian_corrected()
        eqn = None
        data = Phi_field.data
        for _ in range(max(nno, 1)):
            eqn = fvm.laplacian(mesh, 1.0, Phi_field,
                                corrected=corrected, gamma_dims=dimless)
            eqn = eqn.replace_fields(source=eqn.source + src0)
            if needs_reference(Phi_field, mesh):
                eqn = eqn.set_reference(0, 0.0)
            data, perf = linear.solve(mesh, eqn, Phi_field.data, ctl)
            Phi_field = Phi_field.with_data(data)
        phi = phi0 - eqn.flux(mesh, data)
        return Phi_field, phi, perf

    Phi, phi, perf = solve_phi(Phi)
    log.info(log.solver_line("Phi", perf))
    Unew = U.with_data(fvc.reconstruct(mesh, phi))
    case.write_fields([Unew, p])
    case.final_state = {"U": Unew, "phi": phi, "Phi": Phi}
    log.info("End\n")


def _dym_motion(case):
    """(pts_fn, umesh_fn) from constant/dynamicMeshDict solid-body
    motion coefficients (shared by pimpleDyMFoam / interDyMFoam)."""
    from ..mesh import moving

    dmd = case.properties("dynamicMeshDict")
    coeffs = dmd.get("solidBodyMotionFvMeshCoeffs", dmd)
    fn = str(coeffs.get("solidBodyMotionFunction", "linearMotion"))
    c = coeffs.get(fn + "Coeffs", FoamDict())

    def vec(key, default=(0.0, 0.0, 0.0)):
        return tuple(float(q) for q in c.get(key, default))

    def scal(key, default=1.0):
        v = c.get(key, default)
        if isinstance(v, (list, tuple)):
            v = v[-1]
        return float(v)

    if fn == "oscillatingLinearMotion":
        return moving.oscillating_linear_motion(vec("amplitude"),
                                                scal("omega"))
    if fn == "rotatingMotion":
        return moving.rotating_motion(vec("origin"),
                                      vec("axis", (0.0, 0.0, 1.0)),
                                      scal("omega"))
    if fn == "linearMotion":
        return moving.linear_motion(vec("velocity"))
    raise ValueError(f"unsupported solidBodyMotionFunction {fn!r}")


def interfoam_app(case, max_steps: Optional[int] = None,
                  lts: bool = False, dym: bool = False) -> None:
    """interFoam from case files (reference:
    applications/solvers/multiphase/interFoam/)."""
    import jax.numpy as jnp

    from . import interfoam as inter_mod

    mesh = case.mesh
    tp = case.transport_properties()
    # 2.2 layout: phase1 { nu; rho; } phase2 { ... } sigma
    def phase(name):
        ph = tp.get(name, tp)
        _, nu_v = dimensioned_scalar(ph["nu"])
        _, rho_v = dimensioned_scalar(ph["rho"])
        return nu_v, rho_v

    nu1, rho1 = phase("phase1")
    nu2, rho2 = phase("phase2")
    _, sigma = dimensioned_scalar(tp.get("sigma", 0.0))
    g_vec = (0.0, -9.81, 0.0)
    g_path = case.const_path("g")
    if os.path.exists(g_path):
        gd = parse_file(g_path)
        import numpy as _np

        val = gd.get("value")
        if val is not None:
            g_vec = tuple(float(x) for x in _np.asarray(val).reshape(3))

    U = case.read_field("U")
    alpha = None
    for nm in ("alpha1", "alpha.water", "alpha"):
        path = os.path.join(case.dir, "0", nm)
        if os.path.exists(path):
            alpha = case.read_field(nm)
            break
    p_rgh = case.read_field("p_rgh")
    pdict = case.pimple_controls("PIMPLE")
    cfg = inter_mod.InterConfig(
        lts=lts,
        lts_max_co=float(case.control_dict.get("maxCo", 0.5)),
        lts_max_dt=float(case.control_dict.get("maxDeltaT", 1e6)),
        rho1=rho1, rho2=rho2, nu1=nu1, nu2=nu2, sigma=sigma, g=g_vec,
        c_alpha=float(pdict.get("cAlpha", 1.0)),
        n_alpha_subcycles=int(pdict.get("nAlphaSubCycles", 1)),
        n_correctors=int(pdict.get("nCorrectors", 3)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        p_controls=case.solver_controls("p_rgh"),
        u_controls=case.solver_controls("U") if "U" in str(
            case.fv_solution.get("solvers", {})) else None,
        fv_options=_load_fvoptions(case, min(nu1, nu2)),
        mrf=_load_mrf(case),
    )
    if dym:
        dmd = case.properties("dynamicMeshDict")
        if str(dmd.get("dynamicFvMesh", "")) == "dynamicRefineFvMesh":
            # interDyMFoam + dynamicRefineFvMesh: adaptive refinement
            # around the interface (reference: damBreakWithObstacle)
            return _inter_amr_run(case, cfg, dmd, max_steps)
        # interDyMFoam (reference: interFoam/interDyMFoam): solid-body
        # mesh motion + relative-flux formulation
        pts_fn, umesh_fn = _dym_motion(case)
        step = inter_mod.make_dym_step(mesh, cfg, pts_fn, umesh_fn)
        state = inter_mod.interdym_initial_state(
            case.poly_mesh, mesh, U, p_rgh, alpha, cfg, umesh_fn)
    else:
        step = inter_mod.make_step(mesh, cfg)
        state = inter_mod.initial_state(mesh, U, p_rgh, alpha, cfg)

    from ..functionobjects import make_function_objects

    fol = make_function_objects(case)
    log.info(f"Starting time loop: interFoam, {mesh.n_cells} cells\n")
    for t in case.time.loop():
        dt = jnp.asarray(t.current_dt, mesh.v.dtype)
        state, diag = step(state, dt)
        log.info(f"Time = {t.name}")
        log.info(f"Phase-1 volume fraction: min = "
                 f"{float(diag['alpha_min']):.6g} max = "
                 f"{float(diag['alpha_max']):.6g}")
        from .linear.krylov import SolverPerf as _SP

        log.info(log.solver_line("p_rgh", _SP(
            diag["p_initial"], diag["p_final"], diag["p_iters"])) + "\n")
        fol.execute(t.name, state)
        t.adjust_delta_t(float(diag["courant_max"]))
        if t.write_time():
            case.write_fields([state["U"], state["p_rgh"], state["alpha"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p_rgh"], state["alpha"]])
    case.final_state = state
    log.info("End\n")


def _field_on_mesh(case, name: str, mesh2, data):
    """Rebuild a 0/ field's BC structure on a NEW (adapted) mesh with
    the given remapped cell data (AMR: patch face counts change every
    adaptation, so the boundaryField dict is re-instantiated against
    the new patches; per-face nonuniform BC values are not remapped —
    uniform/keyword BCs, the damBreak pattern, are exact)."""
    import jax.numpy as jnp

    from ..bc import factory as bc_factory
    from ..bc.patchfields import normalize_bcs
    from ..core.dimensions import DimensionSet
    from ..core.fields import VolField
    from ..io.fields import load_field_dict

    path = os.path.join(case.dir, "0", name)
    d = load_field_dict(path)
    dims = d.get("dimensions", DimensionSet.of())
    if not isinstance(dims, DimensionSet):
        dims = DimensionSet.of()
    rank = 1 if data.ndim == 2 else 0
    dtype = mesh2.v.dtype
    bf = d["boundaryField"]
    bcs = []
    for p in mesh2.patches:
        spec = bf.match(p.name)
        bcs.append(bc_factory.from_dict(spec, p, rank, dtype,
                                        mesh=mesh2))
    return VolField(data=jnp.asarray(data, dtype),
                    bcs=normalize_bcs(mesh2, tuple(bcs), rank),
                    name=name, dims=dims)


def _correct_phi(mesh, phi, p_like):
    """Projection of a remapped flux to div-free (reference:
    correctPhi.H): laplacian(pcorr) == div(phi); phi -= flux(pcorr)."""
    import jax.numpy as jnp

    from ..core.dimensions import dimTime
    from ..ops import fvm, surface
    from . import linear
    from .piso import needs_reference

    pcorr = p_like.with_data(jnp.zeros_like(p_like.data))
    pEqn = fvm.laplacian(mesh, jnp.asarray(1.0, mesh.v.dtype), pcorr,
                         gamma_dims=dimTime)
    pEqn = pEqn.replace_fields(
        source=pEqn.source + surface.surface_sum(mesh, phi))
    pEqn, ctl = linear.prep_pressure(
        pEqn, needs_reference(pcorr, mesh),
        {"solver": "PCG", "preconditioner": "polynomial",
         "tolerance": 1e-8, "relTol": 0.0, "maxIter": 1000}, 0, 0.0)
    data, _ = linear.solve(mesh, pEqn, pcorr.data, ctl)
    return phi - pEqn.flux(mesh, data)


def _inter_amr_run(case, cfg, dmd, max_steps: Optional[int]) -> None:
    """interFoam on dynamicRefineFvMesh (reference:
    src/dynamicFvMesh/dynamicRefineFvMesh + the damBreakWithObstacle
    tutorial): every refineInterval steps the octree adapts to the
    alpha band, fields remap volume-conservatively, and the jitted
    step recompiles for the new topology (mesh/refine.py). The flux is
    rebuilt from the remapped velocity; the reference's correctPhi
    projection is the first PISO corrector of the next step."""
    import jax.numpy as jnp

    from ..mesh import refine, to_device as _to_dev
    from ..ops import fvc
    from . import interfoam as inter_mod

    coeffs = dmd.get("dynamicRefineFvMeshCoeffs", FoamDict())
    interval = int(_dim_scalar_of(coeffs, "refineInterval", 1))
    fname = str(coeffs.get("field", "alpha1"))
    lower = _dim_scalar_of(coeffs, "lowerRefineLevel", 0.001)
    upper = _dim_scalar_of(coeffs, "upperRefineLevel", 0.999)
    max_lvl = int(_dim_scalar_of(coeffs, "maxRefinement", 1))
    n_buf = int(_dim_scalar_of(coeffs, "nBufferLayers", 1))
    max_cells = int(_dim_scalar_of(coeffs, "maxCells", 500000))

    amr, pm = refine.amr_init(case.poly_mesh)
    # permutation original (blockMesh) order -> canonical octree order
    pm0 = case.poly_mesh
    nx, ny, nz = amr.base_n
    ext = amr.bb_max - amr.bb_min
    ijk = np.clip(np.floor((pm0.c - amr.bb_min) / ext
                           * np.array([nx, ny, nz])).astype(int),
                  0, np.array([nx, ny, nz]) - 1)
    canon_idx = {c: i for i, c in enumerate(amr.cells)}
    perm = np.array([canon_idx[(0, int(i), int(j), int(k))]
                     for i, j, k in ijk])
    mesh = _to_dev(pm)
    case._poly, case._mesh = pm, mesh

    def reorder(f):
        out = np.empty_like(np.asarray(f.data))
        out[perm] = np.asarray(f.data)
        return out

    alpha_name = next(nm for nm in ("alpha1", "alpha.water", "alpha")
                      if os.path.exists(os.path.join(case.dir, "0",
                                                     nm)))
    U = _field_on_mesh(case, "U", mesh, reorder(case.read_field("U")))
    p_rgh = _field_on_mesh(case, "p_rgh", mesh,
                           reorder(case.read_field("p_rgh")))
    alpha = _field_on_mesh(case, alpha_name, mesh,
                           reorder(case.read_field(alpha_name)))
    state = inter_mod.initial_state(mesh, U, p_rgh, alpha, cfg)
    step = inter_mod.make_step(mesh, cfg)

    log.info(f"Starting time loop: interDyMFoam/dynamicRefineFvMesh, "
             f"{mesh.n_cells} cells\n")
    diag = {}
    for t in case.time.loop():
        state, diag = step(state, jnp.asarray(t.current_dt,
                                              mesh.v.dtype))
        log.info(f"Time = {t.name}\nPhase-1 volume fraction: min = "
                 f"{float(diag['alpha_min']):.6g} max = "
                 f"{float(diag['alpha_max']):.6g}  cells = "
                 f"{mesh.n_cells}\n")
        t.adjust_delta_t(float(diag["courant_max"]))
        if t.index % interval == 0:
            a_host = np.asarray(state["alpha"].data)
            out = refine.adapt(amr, pm, a_host, lower, upper, max_lvl,
                               n_buf, max_cells)
            if out is not None:
                amr2, pm2 = out
                vo, vn = refine.build_maps(amr, amr2)
                mesh2 = _to_dev(pm2)
                n2 = pm2.n_cells

                def rm(f):
                    return refine.remap_field(np.asarray(f.data),
                                              vo, vn, n2)

                U = _field_on_mesh(case, "U", mesh2, rm(state["U"]))
                p_rgh = _field_on_mesh(case, "p_rgh", mesh2,
                                       rm(state["p_rgh"]))
                alpha = _field_on_mesh(case, alpha_name, mesh2,
                                       rm(state["alpha"]))
                state = inter_mod.initial_state(mesh2, U, p_rgh,
                                                alpha, cfg)
                # correctPhi (reference: correctPhi.H): project the
                # rebuilt flux to div-free so the next MULES step
                # stays bounded
                state["phi"] = _correct_phi(mesh2, state["phi"],
                                            p_rgh)
                # refresh KD-tree wall distance on any y_wall-carrying
                # model before the re-jit (no-op on the laminar path)
                from ..mesh.walldist import refresh_wall_distance

                refresh_wall_distance(getattr(cfg, "turb", None), pm2,
                                      np.asarray(mesh2.v).dtype)
                step = inter_mod.make_step(mesh2, cfg)
                amr, pm, mesh = amr2, pm2, mesh2
                case._poly, case._mesh = pm, mesh
                log.info(f"Refined mesh: {mesh.n_cells} cells\n")
        if t.write_time():
            case.write_fields([state["U"], state["p_rgh"],
                               state["alpha"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p_rgh"], state["alpha"]])
    case.final_state = state
    case.final_state["n_cells"] = mesh.n_cells
    log.info("End\n")


def rhocentralfoam_app(case, max_steps: Optional[int] = None) -> None:
    """rhoCentralFoam from case files (reference:
    applications/solvers/compressible/rhoCentralFoam/)."""
    import jax.numpy as jnp

    from ..models import thermo as thermo_mod
    from . import rhocentral as rc_mod

    mesh = case.mesh
    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    U = case.read_field("U")
    T = case.read_field("T")
    p_f = case.read_field("p")
    rho_data = th.rho(p_f.data, T.data)
    from ..bc.patchfields import default_bcs
    from ..core.dimensions import DimensionSet
    from ..core.fields import VolField

    rho = VolField(data=rho_data, bcs=default_bcs(mesh, 0), name="rho",
                   dims=DimensionSet.of(1, -3, 0))
    scheme = str(case.fv_schemes.get("fluxScheme", "Kurganov"))
    cfg = rc_mod.RhoCentralConfig(thermo=th, flux_scheme=scheme)
    chunk_n = int(os.environ.get("FOAMTPU_CHUNK", "10"))
    chunk = rc_mod.make_chunk(mesh, cfg, chunk_n)
    state = rc_mod.initial_state(mesh, rho, U, T, cfg)

    log.info(f"Starting time loop: rhoCentralFoam, {mesh.n_cells} cells\n")
    t = case.time
    n_steps = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        n_steps = min(n_steps, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)
    while t.index < n_steps:
        state, diag = chunk(state, dt)
        t.index += chunk_n
        t.value = t.start_time + t.index * t.delta_t
        log.info(f"Time = {t.name}  Courant = "
                 f"{float(diag['courant_max']):.4g}  rho: "
                 f"[{float(diag['rho_min']):.4g}, {float(diag['rho_max']):.4g}]")
        if t.write_time():
            case.write_fields([state["U"], state["T"], state["rho"]])
    case.write_fields([state["U"], state["T"], state["rho"]])
    case.final_state = state
    log.info("End\n")


def rhocentral_dym_foam(case, max_steps: Optional[int] = None) -> None:
    """rhoCentralDyMFoam (reference: applications/solvers/compressible/
    rhoCentralFoam/rhoCentralDyMFoam/): the KNP step on a solid-body
    moving mesh from constant/dynamicMeshDict (relative convection,
    absolute pressure work; volume-preserving motions — documented in
    solvers/rhocentral.py)."""
    import jax
    import jax.numpy as jnp

    from ..bc.patchfields import default_bcs
    from ..core.dimensions import DimensionSet
    from ..core.fields import VolField
    from ..mesh import moving
    from ..models import thermo as thermo_mod
    from . import rhocentral as rc_mod

    mesh = case.mesh
    th = thermo_mod.from_dict(
        case.properties("thermophysicalProperties"))
    U = case.read_field("U")
    T = case.read_field("T")
    p_f = case.read_field("p")
    rho = VolField(data=th.rho(p_f.data, T.data),
                   bcs=default_bcs(mesh, 0), name="rho",
                   dims=DimensionSet.of(1, -3, 0))
    scheme = str(case.fv_schemes.get("fluxScheme", "Kurganov"))
    cfg = rc_mod.RhoCentralConfig(thermo=th, flux_scheme=scheme)
    pts_fn, umesh_fn = _dym_motion(case)
    pm = case.poly_mesh
    state = rc_mod.initial_state(mesh, rho, U, T, cfg)
    state["topo"] = moving.topo_from_poly(pm, mesh.v.dtype)
    state["points0"] = jnp.asarray(pm.points, mesh.v.dtype)
    state["t"] = jnp.zeros((), mesh.v.dtype)
    step = jax.jit(lambda s, d: rc_mod.rhocentraldym_step(
        mesh, s, d, cfg, pts_fn, umesh_fn))
    log.info(f"Starting time loop: rhoCentralDyMFoam, "
             f"{mesh.n_cells} cells\n")
    for t in case.time.loop():
        state, diag = step(state, jnp.asarray(t.current_dt,
                                              mesh.v.dtype))
        log.info(f"Time = {t.name}  Courant = "
                 f"{float(diag['courant_max']):.4g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["T"], state["rho"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["T"], state["rho"]])
    case.final_state = state
    log.info("End\n")


def _load_radiation(case):
    """constant/radiationProperties -> P1Config | FvDOMConfig | None
    (reference: radiationModel::New)."""
    rad_path = case.const_path("radiationProperties")
    if not os.path.exists(rad_path):
        return None
    rd = parse_file(rad_path)
    if str(rd.get("radiation", "on")) not in ("on", "yes", "true"):
        return None
    model = str(rd.get("radiationModel", "none"))
    from ..models import radiation as rad_mod

    cc = rd.get("constantAbsorptionEmissionCoeffs", FoamDict())
    a = _dim_scalar_of(cc, "absorptivity", 0.5)
    e = _dim_scalar_of(cc, "emissivity", 0.5)
    s = _dim_scalar_of(cc, "scatter", 0.0)
    if model == "P1":
        return rad_mod.P1Config(a=a, e=e, s=s, emissivity=1.0)
    if model == "fvDOM":
        fc = rd.get("fvDOMCoeffs", FoamDict())
        return rad_mod.FvDOMConfig(
            a=a, e=e, s=s, emissivity=1.0,
            n_theta=int(fc.get("nTheta", 2)),
            n_phi=int(fc.get("nPhi", 2)))
    return None


def _read_gravity(case) -> Tuple[float, float, float]:
    """constant/g (reference: uniformDimensionedVectorField g)."""
    path = case.const_path("g")
    if os.path.exists(path):
        d = parse_file(path)
        v = np.asarray(d.get("value")).reshape(-1)
        return (float(v[0]), float(v[1]), float(v[2]))
    return (0.0, -9.81, 0.0)


def _dim_scalar_of(d: FoamDict, key: str, default: float) -> float:
    if key not in d:
        return default
    try:
        _, v = dimensioned_scalar(d[key])
        return float(v)
    except Exception:
        return float(d[key])


def _boussinesq_run(case, steady: bool, max_steps: Optional[int]) -> None:
    """Shared driver for buoyantBoussinesq{Simple,Pimple}Foam
    (reference: applications/solvers/heatTransfer/)."""
    import jax.numpy as jnp

    from . import buoyant as buoy_mod

    mesh = case.mesh
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    model, tstate = _load_turbulence(case, nu)
    relax = _relaxation(case)
    cname = "SIMPLE" if steady else "PIMPLE"
    cdict = case.pimple_controls(cname)
    turb_ctl = None
    try:
        turb_ctl = case.solver_controls("k")
    except KeyError:
        pass
    try:
        pf_ctl = case.solver_controls("p_rghFinal")
    except KeyError:
        pf_ctl = None
    cfg = buoy_mod.BoussinesqConfig(
        nu=nu,
        beta=_dim_scalar_of(tp, "beta", 3e-3),
        t_ref=_dim_scalar_of(tp, "TRef", 300.0),
        pr=_dim_scalar_of(tp, "Pr", 0.7),
        prt=_dim_scalar_of(tp, "Prt", 0.85),
        g=_read_gravity(case),
        steady=steady,
        n_outer=int(cdict.get("nOuterCorrectors", 1)),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        div_scheme_t=case.div_scheme("div(phi,T)"),
        ddt_scheme=case.ddt_scheme(),
        grad_scheme=case.grad_scheme("grad(p_rgh)"),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        p_ref_value=float(cdict.get("pRefValue", 0.0)),
        alpha_u=relax.get("U", 0.3 if steady else 1.0),
        alpha_p=relax.get("p_rgh", 0.7 if steady else 1.0),
        alpha_t=relax.get("T", 0.5 if steady else 1.0),
        p_controls=case.solver_controls("p_rgh"),
        p_controls_final=pf_ctl,
        u_controls=case.solver_controls("U"),
        t_controls=case.solver_controls("T"),
        turb=model,
        turb_controls=turb_ctl,
        turb_relax=relax.get("k", 0.7),
    )
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    T = case.read_field("T")
    state = buoy_mod.initial_state(mesh, U, p_rgh, T, turb_state=tstate,
                                   steady=steady)
    chunk_n = int(os.environ.get("FOAMTPU_CHUNK", "10"))
    chunk = buoy_mod.make_chunk(mesh, cfg, chunk_n)
    res_ctl = _residual_control(case, cname)
    extra = model.field_names[:-1] if model else ()
    name = ("buoyantBoussinesqSimpleFoam" if steady
            else "buoyantBoussinesqPimpleFoam")
    log.info(f"Starting loop: {name}, {mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(1.0 if steady else t.delta_t, mesh.v.dtype)
    from ..functionobjects import make_function_objects

    fol = make_function_objects(case)

    def write(state):
        fields = [state["U"], state["p_rgh"], state["T"]]
        if "turb" in state and state["turb"]:
            fields += list(state["turb"].values())
        case.write_fields(fields)

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = chunk(state, dt)
        t.index += chunk_n
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative, extra)
        log.info(log.solver_line("T", diag["T"]))
        fol.execute(t.name, state)
        if t.write_time():
            write(state)
        if steady and simple_mod.converged(diag, res_ctl):
            log.info(f"SIMPLE solution converged in {t.index} iterations\n")
            break
    write(state)
    log.info("End\n")
    case.final_state = state


def buoyant_boussinesq_simplefoam(case, max_steps: Optional[int] = None):
    _boussinesq_run(case, steady=True, max_steps=max_steps)


def buoyant_boussinesq_pimplefoam(case, max_steps: Optional[int] = None):
    _boussinesq_run(case, steady=False, max_steps=max_steps)


def _buoyant_rho_run(case, steady: bool, max_steps: Optional[int]) -> None:
    """Shared driver for buoyant{Simple,Pimple}Foam — compressible
    buoyant heat transfer (reference:
    applications/solvers/heatTransfer/buoyantSimpleFoam/)."""
    import jax.numpy as jnp

    from ..models import thermo as thermo_mod
    from . import buoyantrho as br_mod

    mesh = case.mesh
    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    model, tstate = _load_turbulence(case, max(th.mu, 1e-12),
                                     compressible=True)
    relax = _relaxation(case)
    cname = "SIMPLE" if steady else "PIMPLE"
    cdict = case.pimple_controls(cname)
    try:
        pf_ctl = case.solver_controls("p_rghFinal")
    except KeyError:
        pf_ctl = None
    cfg = br_mod.BuoyantRhoConfig(
        thermo=th,
        g=_read_gravity(case),
        steady=steady,
        n_outer=int(cdict.get("nOuterCorrectors", 1)),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        div_scheme_e=case.div_scheme("div(phi,e)"),
        grad_scheme=case.grad_scheme("grad(p_rgh)"),
        alpha_u=relax.get("U", 0.3 if steady else 1.0),
        alpha_p=relax.get("p_rgh", 0.7 if steady else 1.0),
        alpha_e=relax.get("h", relax.get("e", 0.3 if steady else 1.0)),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        p_ref_value=float(cdict.get("pRefValue", 1e5)),
        p_controls=case.solver_controls("p_rgh"),
        p_controls_final=pf_ctl,
        u_controls=case.solver_controls("U"),
        e_controls=case.solver_controls("T") if _has_solver(case, "T")
        else None,
        turb=model,
        turb_relax=relax.get("k", 0.7),
    )
    # radiation (constant/radiationProperties, model P1 or fvDOM)
    rad = _load_radiation(case)
    if rad is not None:
        cfg = cfg._replace(radiation=rad)
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    T = case.read_field("T")
    state = br_mod.initial_state(mesh, U, p_rgh, T, th, g=cfg.g,
                                 turb_state=tstate, steady=steady)
    if cfg.radiation is not None:
        from ..models import radiation as rad_mod

        state["G"] = rad_mod.make_G(mesh, cfg.radiation, T.bcs)
    step = br_mod.make_step(mesh, cfg)
    res_ctl = _residual_control(case, cname)
    name = "buoyantSimpleFoam" if steady else "buoyantPimpleFoam"
    log.info(f"Starting loop: {name}, {mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(1.0 if steady else t.delta_t, mesh.v.dtype)
    from ..functionobjects import make_function_objects

    fol = make_function_objects(case)

    def write(state):
        fields = [state["U"], state["p_rgh"], state["T"]]
        if "turb" in state and state["turb"]:
            fields += list(state["turb"].values())
        case.write_fields(fields)

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        log.info(log.solver_line("T", diag["T"]))
        fol.execute(t.name, state)
        if t.write_time():
            write(state)
        if steady and simple_mod.converged(diag, res_ctl):
            log.info(f"SIMPLE solution converged in {t.index} iterations\n")
            break
    write(state)
    log.info("End\n")
    case.final_state = state


def buoyant_simplefoam(case, max_steps: Optional[int] = None):
    _buoyant_rho_run(case, steady=True, max_steps=max_steps)


def buoyant_pimplefoam(case, max_steps: Optional[int] = None):
    _buoyant_rho_run(case, steady=False, max_steps=max_steps)


def _read_positions(path: str) -> np.ndarray:
    """Parse an OpenFOAM positions file (class vectorField /
    Cloud positions: `( (x y z) ... )`, possibly with trailing cell
    labels `(x y z) celli`)."""
    import re

    txt = open(path).read()
    txt = re.sub(r"/\*.*?\*/", "", txt, flags=re.S)
    txt = re.sub(r"//.*", "", txt)
    vecs = re.findall(
        r"\(\s*(-?[\d.eE+-]+)\s+(-?[\d.eE+-]+)\s+(-?[\d.eE+-]+)\s*\)",
        txt)
    return np.asarray([[float(a), float(b), float(c)]
                       for a, b, c in vecs], dtype=float)


def ico_uncoupled_kinematic_parcel_foam(case,
                                        max_steps: Optional[int] = None
                                        ) -> None:
    """icoUncoupledKinematicParcelFoam (reference: applications/
    solvers/lagrangian/icoUncoupledKinematicParcelFoam/): a frozen
    carrier velocity field transports a kinematic parcel cloud
    (manualInjection from kinematicCloudPositions, sphere drag +
    gravity)."""
    import jax.numpy as jnp

    from .. import lagrangian as lag

    mesh = case.mesh
    U = case.read_field("U")
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    rho_f = _dim_scalar_of(tp, "rhoInf", _dim_scalar_of(tp, "rho", 1.2))
    mu_f = nu * rho_f
    props = case.properties("kinematicCloudProperties")
    cp = props.get("constantProperties", FoamDict())
    rho0 = _dim_scalar_of(cp, "rho0", 1000.0)
    sub = props.get("subModels", props)
    inj = FoamDict()
    im = sub.get("injectionModels", sub.get("injectionModel"))
    if isinstance(im, FoamDict):
        for v in im.values():
            if isinstance(v, FoamDict):
                inj = v
                break
        else:
            inj = im
    d0 = _dim_scalar_of(inj, "d0", _dim_scalar_of(cp, "d0", 100e-6))
    U0v = inj.get("U0", [0, 0, 0])
    U0 = np.asarray(U0v[-1] if isinstance(U0v, list)
                    and isinstance(U0v[-1], (list, np.ndarray)) else U0v,
                    dtype=float).reshape(-1)[-3:]
    pos_path = case.const_path("kinematicCloudPositions")
    pos = (_read_positions(pos_path) if os.path.exists(pos_path)
           else np.asarray([[float(x) for x in
                             np.asarray(mesh.c)[0]]]))
    cfg = lag.CloudConfig(rho_f=rho_f, mu_f=mu_f, g=_read_gravity(case))
    cloud = lag.make_cloud(mesh, pos, U0, d0, rho0)
    bt = jnp.asarray(lag.face_boundary_types(mesh))
    step = __import__("jax").jit(
        lambda c, dt: lag.evolve(mesh, c, U.data, dt, bt, cfg))

    def write(t):
        d = os.path.join(case.dir, t.name, "lagrangian",
                         "kinematicCloud")
        os.makedirs(d, exist_ok=True)
        act = np.asarray(cloud.active)
        x = np.asarray(cloud.x)[act]
        u = np.asarray(cloud.u)[act]
        with open(os.path.join(d, "positions"), "w") as f:
            f.write("FoamFile { version 2.0; format ascii; "
                    "class Cloud<basicKinematicParcel>; "
                    "object positions; }\n")
            f.write(f"{len(x)}\n(\n")
            for p, ci in zip(x, np.asarray(cloud.cell)[act]):
                f.write(f"({p[0]:.8g} {p[1]:.8g} {p[2]:.8g}) {ci}\n")
            f.write(")\n")
        with open(os.path.join(d, "U"), "w") as f:
            f.write("FoamFile { version 2.0; format ascii; "
                    "class vectorField; object U; }\n")
            f.write(f"{len(u)}\n(\n")
            for p in u:
                f.write(f"({p[0]:.8g} {p[1]:.8g} {p[2]:.8g})\n")
            f.write(")\n")
        # origId: stable slot index per parcel so particleTracks can
        # correlate positions across times (reference: the parcel's
        # origProc/origId pair in Cloud<particle> IO)
        ids = np.nonzero(act)[0]
        with open(os.path.join(d, "origId"), "w") as f:
            f.write("FoamFile { version 2.0; format ascii; "
                    "class labelField; object origId; }\n")
            f.write(f"{len(ids)}\n(\n")
            f.write("\n".join(str(int(i)) for i in ids))
            f.write("\n)\n")

    log.info(f"Starting loop: icoUncoupledKinematicParcelFoam, "
             f"{len(pos)} parcels\n")
    for t in case.time.loop():
        cloud = step(cloud, jnp.asarray(t.current_dt, mesh.v.dtype))
        n_act = int(cloud.n_active)
        log.info(f"Time = {t.name}\nCloud: kinematicCloud  active "
                 f"parcels = {n_act}\n")
        if t.write_time():
            write(t)
        if max_steps is not None and t.index >= max_steps:
            break
    write(case.time)
    log.info("End\n")
    case.final_state = {"cloud": cloud, "U": U}


def adjoint_shape_optimization_foam(case,
                                    max_steps: Optional[int] = None
                                    ) -> None:
    """adjointShapeOptimizationFoam (reference: applications/solvers/
    incompressible/adjointShapeOptimizationFoam/): primal+adjoint
    SIMPLE with a porosity design variable. lambda/alphaMax from
    constant/transportProperties."""
    import jax.numpy as jnp

    from ..core.fields import vol_scalar, vol_vector
    from . import adjoint as adj_mod
    from . import simple as simple_mod

    mesh = case.mesh
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    relax = _relaxation(case)
    flow = simple_mod.SimpleConfig(
        nu=nu,
        alpha_u=float(relax.get("U", 0.7)),
        alpha_p=float(relax.get("p", 0.3)),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"))
    U = case.read_field("U")
    p = case.read_field("p")
    try:
        Ua = case.read_field("Ua")
        pa = case.read_field("pa")
    except Exception:
        Ua = vol_vector(mesh, (0.0, 0.0, 0.0), name="Ua")
        pa = vol_scalar(mesh, 0.0, name="pa")
    # keep alpha zero in inlet-adjacent cells (reference: zeroCells)
    owner = np.asarray(mesh.owner)
    inlet_cells = []
    for pt in mesh.patches:
        if pt.type == "patch" and "in" in pt.name.lower():
            inlet_cells.append(np.unique(owner[pt.slice]))
    zc = (jnp.asarray(np.concatenate(inlet_cells).astype(np.int32))
          if inlet_cells else None)
    cfg = adj_mod.AdjointConfig(
        flow=flow,
        lam=_dim_scalar_of(tp, "lambda", 1e5),
        alpha_max=_dim_scalar_of(tp, "alphaMax", 200.0),
        zero_alpha_cells=zc)
    state = adj_mod.initial_state(mesh, U, p, Ua, pa, cfg)
    step = adj_mod.make_step(mesh, cfg)
    log.info("Starting loop: adjointShapeOptimizationFoam\n")
    for t in case.time.loop():
        state, diag = step(state)
        log.info(f"Time = {t.name}\nobjective = "
                 f"{float(diag['objective']):.6g}  alpha_max = "
                 f"{float(diag['alpha_max_val']):.4g}\n")
        if t.write_time():
            from ..core.fields import VolField

            alpha_f = vol_scalar(mesh, 0.0, name="alpha").with_data(
                state["alpha"])
            case.write_fields([state["U"], state["p"], state["Ua"],
                               state["pa"], alpha_f])
        if max_steps is not None and t.index >= max_steps:
            break
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def _reacting_parcel_run(case, max_steps: Optional[int], coal=False,
                         spray=False, porous=False,
                         film=False, lts=False) -> None:
    """Shared driver for the reacting-parcel solver family (reference:
    applications/solvers/lagrangian/{reactingParcelFoam,
    porousExplicitSourceReactingParcelFoam,coalChemistryFoam,
    sprayFoam}): a rhoPimpleFoam carrier + an evaporating (or
    devolatilising) thermo parcel cloud, two-way coupled
    (momentum via drag, vapour/volatile mass into the Yvapour
    transport, latent/combustion heat into T). Operator-split per
    step — the reference's intra-PIMPLE source coupling converges the
    same splitting over outer correctors."""
    import jax
    import jax.numpy as jnp

    from .. import lagrangian as lag
    from ..lagrangian import reactingcloud as rcloud
    from ..core.dimensions import DimensionSet, dimless
    from ..core.fields import VolField, vol_scalar
    from ..models import thermo as thermo_mod
    from . import rhopimple as rp_mod
    from . import linear
    from ..ops import fvm, slot as slot_mod, schemes as schemes_mod, \
        surface

    mesh = case.mesh
    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    cdict = case.pimple_controls("PIMPLE")
    cfg = rp_mod.RhoPimpleConfig(
        thermo=th, steady=False,
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        p_ref_value=1e5,
        p_controls=case.solver_controls("p"),
        fv_options=_load_fvoptions(case, th.mu) if porous else None)
    U = case.read_field("U")
    p = case.read_field("p")
    T = case.read_field("T")
    try:
        Yv = case.read_field("Yvapour")
    except Exception:
        Yv = vol_scalar(mesh, 0.0, name="Yvapour")
    state = rp_mod.initial_state(mesh, U, p, T, th)
    if porous and cfg.fv_options:
        state["fvopt"] = cfg.fv_options.initial_state(mesh)
    flow_step = rp_mod.make_step(mesh, cfg)

    # ---- cloud setup ----------------------------------------------------------
    props_name = ("coalCloud1Properties" if coal else
                  "reactingCloud1Properties")
    try:
        props = case.properties(props_name)
    except Exception:
        props = FoamDict()
    cp = props.get("constantProperties", FoamDict())
    rho0 = _dim_scalar_of(cp, "rho0", 1400.0 if coal else 1000.0)
    d0 = _dim_scalar_of(cp, "d0", 100e-6)
    T0p = _dim_scalar_of(cp, "T0", 300.0)
    pos_path = case.const_path(
        "coalCloud1Positions" if coal else "reactingCloudPositions")
    if os.path.exists(pos_path):
        pos = _read_positions(pos_path)
    else:
        pos = np.asarray(mesh.c)[:: max(1, mesh.n_cells // 32)][:32]
    n_slots = max(4 * len(pos), 64) if spray else len(pos)
    lcfg = lag.CloudConfig(
        rho_f=float(np.asarray(p.data).mean())
        / (th.R * float(np.asarray(T.data).mean())),
        mu_f=th.mu, g=_read_gravity(case), solve_T=True,
        cp_p=_dim_scalar_of(cp, "Cp0", 4187.0))
    cloud = lag.make_cloud(mesh, pos, [0.0, 0.0, 0.0], d0, rho0,
                           n_slots=n_slots, T0=T0p)
    ecfg = rcloud.EvapConfig(
        K_evap=_dim_scalar_of(props, "Kevap", 1e-8),
        L_vap=_dim_scalar_of(cp, "Lvap", 2.26e6))
    # phaseChangeModel liquidEvaporation selects the SLGThermo liquid
    # property path (reference: subModels/Reacting/PhaseChangeModel/
    # LiquidEvaporation + liquidProperties); the liquid is named by a
    # `liquid` keyword or defaults to the tutorial fuels
    pc_model = str(props.get("subModels", FoamDict()).get(
        "phaseChangeModel", "none")).strip()
    liquid = None
    if pc_model.startswith("liquidEvaporation"):
        from ..models import liquids as liquids_mod

        lname = str(props.get("liquid", "C7H16" if spray else "H2O"))
        ldict = props.get(lname + "Coeffs")
        liquid = (liquids_mod.from_dict(lname, ldict) if ldict
                  else liquids_mod.get(lname))
    ccfg = rcloud.CoalConfig(Yvol0=_dim_scalar_of(cp, "Yvolatile",
                                                  0.4))
    coal_state = (rcloud.CoalCloud(
        base=cloud, yvol=jnp.full_like(cloud.d, ccfg.Yvol0))
        if coal else None)
    bcfg = rcloud.BreakupConfig(rho_f=lcfg.rho_f)
    inj = None
    if spray:
        inj_d = props.get("injection", FoamDict())
        apex = inj_d.get("position", list(np.asarray(mesh.c)[0]))
        direc = inj_d.get("direction", [0.0, -1.0, 0.0])
        inj = lag.cone_injection(
            mesh, [float(x) for x in np.asarray(apex,
                                                float).reshape(-1)[-3:]],
            [float(x) for x in np.asarray(direc,
                                          float).reshape(-1)[-3:]],
            half_angle_deg=_dim_scalar_of(inj_d, "coneAngle", 10.0),
            u_mag=_dim_scalar_of(inj_d, "Umag", 50.0), d0=d0,
            rho0=rho0, rate=_dim_scalar_of(inj_d, "parcelsPerSecond",
                                           1000.0))
    bt_host = lag.face_boundary_types(mesh)
    bt = jnp.asarray(bt_host)

    name = ("coalChemistryFoam" if coal else
            "sprayFoam" if spray else
            "porousExplicitSourceReactingParcelFoam" if porous else
            "reactingParcelFilmFoam" if film else
            "LTSReactingParcelFoam" if lts else
            "reactingParcelFoam")

    # LTS (reference: LTSReactingParcelFoam's fv::localEulerDdt): the
    # carrier and species equations advance on a per-cell pseudo-time
    # from the local Courant limit; parcels keep the global deltaT
    lts_max_co = float(case.control_dict.get("maxCo", 0.5))
    lts_max_dt = float(case.control_dict.get("maxDeltaT", 1.0))

    def _lts_rdt(st, rdt_old):
        from ..ops import slot as slot_mod

        rho_c = jnp.maximum(th.rho(st["p"].data, st["T"].data), 0.01)
        sum_phi = jnp.sum(jnp.abs(st["phi"])[mesh.cface]
                          * jnp.abs(mesh.csign), axis=1)
        rdt = jnp.maximum(sum_phi / (2.0 * lts_max_co * rho_c
                                     * mesh.v), 1.0 / lts_max_dt)
        for _ in range(3):
            nb = slot_mod.nbr_values(mesh, rdt)
            nb = jnp.where(mesh.st_valid > 0, nb, 0.0)
            rdt = jnp.maximum(rdt, 0.7 * jnp.max(nb, axis=1))
        if rdt_old is not None:
            rdt = jnp.maximum(rdt, rdt_old / 1.2)
        return rdt

    lts_rdt_fn = jax.jit(_lts_rdt)

    # ---- surface film (reactingParcelFilmFoam: parcels impinging on
    # film patches deposit their mass; reference: the
    # surfaceFilmModel's parcel injection/absorption coupling) --------------
    fmm = film_cfg = film_state = None
    cell_to_filmface = None
    if film:
        from ..regionmodels import film_init, FilmConfig
        from ..regionmodels.filmmesh import build_film_mesh

        try:
            sfp = case.properties("surfaceFilmProperties")
        except Exception:
            sfp = FoamDict()
        patches = [str(x) for x in (sfp.get("filmPatches")
                                    or ["film"])]
        fmm = build_film_mesh(case.poly_mesh, patches)
        film_cfg = FilmConfig(
            nu=_dim_scalar_of(sfp, "nu", 1e-6),
            rho=_dim_scalar_of(sfp, "rho", 1000.0),
            g=_read_gravity(case), thermo=False)
        film_state = film_init(fmm, film_cfg)
        c2f = np.full(mesh.n_cells, -1, np.int64)
        c2f[np.asarray(fmm.owner_cells)] = np.arange(
            fmm.n_faces)
        cell_to_filmface = jnp.asarray(c2f)
        # film-patch faces ABSORB parcels (escape code)
        for pch in mesh.patches:
            if pch.name in patches:
                bt_host[pch.slice] = lag.BND_ESCAPE
        bt = jnp.asarray(bt_host)

    def cloud_step(cloud_in, coal_in, st, dt, carry, counter):
        """Evolve + sources, jitted as one program."""
        Udata = st["U"].data
        Tdata = st["T"].data
        rho = jnp.maximum(th.rho(st["p"].data, Tdata), 0.01)
        c0 = cloud_in
        if inj is not None:
            c0, carry, counter = lag.inject(c0, inj, carry, counter,
                                            dt)
        c1 = lag.evolve(mesh, c0, Udata, dt, bt, lcfg, T_cell=Tdata)
        # parcels absorbed at boundaries this step (film impingement)
        dep_mask = c0.active & (~c1.active)
        dep_mass_c = jax.ops.segment_sum(
            jnp.where(dep_mask,
                      c1.rho * jnp.pi / 6.0 * c1.d ** 3, 0.0),
            c1.cell, num_segments=mesh.n_cells)
        if spray:
            c1 = rcloud.reitz_diwakar_breakup(c1, Udata, dt, bcfg)
        mom = lag.momentum_source(mesh, c0, c1, 1.0, dt, lcfg)
        vap = jnp.zeros(mesh.n_cells, mesh.v.dtype)
        heat = jnp.zeros(mesh.n_cells, mesh.v.dtype)
        coal_out = coal_in
        if coal:
            coal_out, fuel, qsrc = rcloud.devolatilise(
                coal_in._replace(base=c1), Tdata, dt, ccfg,
                mesh.n_cells)
            c1 = coal_out.base
            vap = fuel
            heat = -qsrc          # combustion HEATS the carrier
        elif liquid is not None:
            c1, vap, heat = rcloud.liquid_evaporate(
                c1, Udata, Tdata, st["p"].data, dt, lcfg, liquid,
                mesh.n_cells)   # latent heat COOLS the carrier
        else:
            c1, vap, hsink = rcloud.evaporate(c1, Udata, Tdata, dt,
                                              lcfg, ecfg, mesh.n_cells)
            heat = hsink          # latent heat COOLS the carrier
        # explicit coupling back into the carrier
        cp_c = th.Cp_of(Tdata)
        T_new = Tdata - dt * heat / (rho * cp_c * mesh.v)
        U_new = Udata + dt * mom / (rho * mesh.v)[:, None]
        return (c1, coal_out, carry, counter, vap,
                st["T"].with_data(T_new), st["U"].with_data(U_new),
                dep_mass_c)

    cloud_step_j = jax.jit(cloud_step)

    def transport_Yv(st, Yv_f, vap, dt):
        """Implicit vapour-species transport + the parcel source."""
        rdt = 1.0 / dt
        rho = jnp.maximum(th.rho(st["p"].data, st["T"].data), 0.01)
        phi = st["phi"]
        phi_slot = slot_mod.from_flat(mesh, phi)
        w = schemes_mod.weights_slot(mesh, phi_slot, "upwind", Yv_f)
        eqn = (rp_mod._rho_ddt(mesh, Yv_f, rho, st["rho0"], Yv_f.data,
                               rdt)
               + fvm.div(mesh, phi, Yv_f, phi_slot=phi_slot,
                         slot_weights=w,
                         phi_dims=DimensionSet.of(1, 0, -1)))
        eqn = eqn.add_source(vap / (dt * mesh.v), mesh)
        data, perf = linear.solve(mesh, eqn, Yv_f.data,
                                  {"solver": "PBiCGStab",
                                   "tolerance": 1e-8, "relTol": 0.05,
                                   "maxIter": 200})
        return Yv_f.with_data(jnp.clip(data, 0.0, 1.0)), perf

    transport_j = jax.jit(transport_Yv)
    carry = jnp.zeros((), mesh.v.dtype)
    counter = jnp.zeros((), jnp.int32)

    log.info(f"Starting loop: {name}, {int(cloud.n_active)} parcels\n")
    diag = {}
    for t in case.time.loop():
        dt = jnp.asarray(t.current_dt, mesh.v.dtype)
        if lts:
            state["lts_rdt"] = lts_rdt_fn(state,
                                          state.get("lts_rdt"))
        state, diag = flow_step(state, dt)
        (cloud, coal_state, carry, counter, vap, T_new,
         U_new, dep_mass_c) = cloud_step_j(cloud, coal_state, state,
                                           dt, carry, counter)
        state = dict(state)
        state["T"] = T_new
        state["U"] = U_new
        state["T0"] = T_new.data
        Yv, yperf = transport_j(state, Yv, vap, dt)
        if film:
            from ..regionmodels import film_step

            ff = cell_to_filmface[jnp.arange(mesh.n_cells)]
            dep_face = jnp.zeros(fmm.n_faces, mesh.v.dtype).at[
                jnp.clip(cell_to_filmface, 0)].add(
                jnp.where(cell_to_filmface >= 0, dep_mass_c, 0.0))
            S_mass = dep_face / (fmm.area * dt)   # kg/m^2/s
            film_state, fdiag = film_step(fmm, film_state, dt,
                                          film_cfg, S_mass=S_mass)
        log.info(f"Time = {t.name}\nCloud: active parcels = "
                 f"{int(cloud.n_active)}, Yvapour mean = "
                 f"{float(jnp.mean(Yv.data)):.6g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["p"], state["T"],
                               Yv])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p"], state["T"], Yv])
    case.final_state = {"state": state, "cloud": cloud, "Yv": Yv,
                        "coal": coal_state, "diag": diag,
                        "film": film_state}
    log.info("End\n")


def reacting_parcel_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps)


def porous_reacting_parcel_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps, porous=True)


def lts_reacting_parcel_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps, lts=True)


def coal_chemistry_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps, coal=True)


def spray_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps, spray=True)


def reacting_parcel_film_foam(case, max_steps: Optional[int] = None):
    _reacting_parcel_run(case, max_steps, film=True)


def potential_free_surface_foam(case, max_steps: Optional[int] = None
                                ) -> None:
    """potentialFreeSurfaceFoam (reference: applications/solvers/
    multiphase/potentialFreeSurfaceFoam/): pisoFoam + the
    waveSurfacePressure free-surface BC. The free-surface patch is the
    one whose p_gh (or p) boundary type is waveSurfacePressure, else a
    patch named freeSurface."""
    import jax.numpy as jnp

    from . import piso as piso_mod
    from . import potentialfreesurface as pfs_mod

    mesh = case.mesh
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    pname = "p_gh" if os.path.exists(os.path.join(case.dir, "0",
                                                  "p_gh")) else "p"
    # find the free-surface patch from the raw boundaryField types
    fs_idx = None
    raw = parse_file(os.path.join(case.dir, "0", pname))
    bf = raw.get("boundaryField", FoamDict())
    for i, p in enumerate(mesh.patches):
        ent = bf.get(p.name)
        if isinstance(ent, FoamDict) and \
                str(ent.get("type")) == "waveSurfacePressure":
            fs_idx = i
            break
    if fs_idx is None:
        for i, p in enumerate(mesh.patches):
            if p.name == "freeSurface":
                fs_idx = i
                break
    if fs_idx is None:
        raise ValueError("potentialFreeSurfaceFoam: no "
                         "waveSurfacePressure patch found")
    g = _read_gravity(case)
    pdict = case.pimple_controls("PIMPLE")
    flow = piso_mod.PisoConfig(
        nu=nu,
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        p_controls=case.solver_controls(pname))
    cfg = pfs_mod.FreeSurfaceConfig(
        flow=flow, fs_patch=fs_idx,
        g_mag=float(np.linalg.norm(np.asarray(g))))
    U = case.read_field("U")
    p = case.read_field(pname)
    state = pfs_mod.initial_state(mesh, U, p, cfg)
    step = pfs_mod.make_step(mesh, cfg)
    log.info("Starting loop: potentialFreeSurfaceFoam\n")
    for t in case.time.loop():
        state, diag = step(state, jnp.asarray(t.current_dt,
                                              mesh.v.dtype))
        log.info(f"Time = {t.name}\nzeta: min = "
                 f"{float(diag['zeta_min']):.6g} max = "
                 f"{float(diag['zeta_max']):.6g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["p"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p"]])
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def settling_foam(case, max_steps: Optional[int] = None) -> None:
    """settlingFoam (reference: applications/solvers/multiphase/
    settlingFoam/): drift-flux mixture with hindered settling from
    constant/transportProperties (rhoc/rhod/muc, V0/a/a1/alphaMin,
    plasticViscosityCoeff/Exponent)."""
    import jax.numpy as jnp

    from . import settling as set_mod

    mesh = case.mesh
    tp = case.transport_properties()
    V0v = tp.get("V0", [0.0, -0.002, 0.0])
    if isinstance(V0v, list) and V0v and isinstance(V0v[-1],
                                                    (list, tuple)):
        V0v = V0v[-1]
    pdict = case.pimple_controls("PIMPLE")
    plast = tp.get("plastic", tp.get("plasticCoeffs", tp))
    cfg = set_mod.SettlingConfig(
        rhoc=_dim_scalar_of(tp, "rhoc", 1000.0),
        rhod=_dim_scalar_of(tp, "rhod", 1042.0),
        muc=_dim_scalar_of(tp, "muc", 1e-3),
        plastic_coeff=_dim_scalar_of(plast, "plasticViscosityCoeff",
                                     0.0),
        plastic_exp=_dim_scalar_of(plast, "plasticViscosityExponent",
                                   0.0),
        vdj_model=str(tp.get("VdjModel", "simple")),
        V0=tuple(float(x) for x in np.asarray(V0v,
                                              float).reshape(-1)[-3:]),
        a=_dim_scalar_of(tp, "a", 8.84),
        a1=_dim_scalar_of(tp, "a1", 0.0),
        alpha_min=_dim_scalar_of(tp, "alphaMin", 0.0),
        g=_read_gravity(case),
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        p_controls=case.solver_controls("p_rgh"))
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    alpha = case.read_field("alpha")
    state = set_mod.initial_state(mesh, U, p_rgh, alpha, cfg)
    step = set_mod.make_step(mesh, cfg)
    log.info("Starting loop: settlingFoam\n")
    for t in case.time.loop():
        state, diag = step(state, jnp.asarray(t.current_dt,
                                              mesh.v.dtype))
        log.info(f"Time = {t.name}\nDispersed phase fraction = "
                 f"{float(jnp.mean(state['alpha'].data)):.6g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["p_rgh"],
                               state["alpha"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p_rgh"], state["alpha"]])
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def inter_mixing_foam(case, max_steps: Optional[int] = None) -> None:
    """interMixingFoam (reference: applications/solvers/multiphase/
    interMixingFoam/): three phases from transportProperties
    (phase1 = air immiscible, phase2/phase3 miscible liquids with
    diffusivity D23)."""
    import jax.numpy as jnp

    from . import interfoam as inter_mod
    from . import intermixing as imx_mod

    mesh = case.mesh
    tp = case.transport_properties()

    def phase(name):
        ph = tp.get(name, tp)
        _, nu_v = dimensioned_scalar(ph["nu"])
        _, rho_v = dimensioned_scalar(ph["rho"])
        return nu_v, rho_v

    nu1, rho1 = phase("phase1")
    nu2, rho2 = phase("phase2")
    nu3, rho3 = phase("phase3")
    _, sigma = dimensioned_scalar(tp.get("sigma", 0.0))
    pdict = case.pimple_controls("PIMPLE")
    flow = inter_mod.InterConfig(
        rho1=rho1, rho2=rho2, nu1=nu1, nu2=nu2, sigma=sigma,
        g=_read_gravity(case),
        c_alpha=float(pdict.get("cAlpha", 1.0)),
        n_correctors=int(pdict.get("nCorrectors", 3)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        p_controls=case.solver_controls("p_rgh"))
    cfg = imx_mod.InterMixingConfig(
        flow=flow, rho3=rho3, nu3=nu3,
        D23=_dim_scalar_of(tp, "D23", 3e-9))
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    alpha1 = case.read_field("alpha1")
    alpha2 = case.read_field("alpha2")
    state = imx_mod.initial_state(mesh, U, p_rgh, alpha1, alpha2, cfg)
    step = imx_mod.make_step(mesh, cfg)
    log.info("Starting loop: interMixingFoam\n")
    for t in case.time.loop():
        state, diag = step(state, jnp.asarray(t.current_dt,
                                              mesh.v.dtype))
        log.info(f"Time = {t.name}\nAir phase volume fraction = "
                 f"{float(jnp.mean(state['alpha1'].data)):.6g}  "
                 f"Liquid A = "
                 f"{float(jnp.mean(state['alpha2'].data)):.6g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["p_rgh"],
                               state["alpha1"], state["alpha2"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p_rgh"], state["alpha1"],
                       state["alpha2"]])
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def inter_phase_change_foam(case, max_steps: Optional[int] = None
                            ) -> None:
    """interPhaseChangeFoam (reference: applications/solvers/
    multiphase/interPhaseChangeFoam/): VOF with cavitation mass
    transfer. transportProperties carries phase1/phase2 + sigma +
    phaseChangeTwoPhaseMixture (SchnerrSauer/Kunz/Merkle) and its
    coeffs dict; pSat from thermodynamicProperties or the coeffs."""
    import jax.numpy as jnp

    from . import interfoam as inter_mod
    from . import interphasechange as ipc_mod

    mesh = case.mesh
    tp = case.transport_properties()

    def phase(name):
        ph = tp.get(name, tp)
        _, nu_v = dimensioned_scalar(ph["nu"])
        _, rho_v = dimensioned_scalar(ph["rho"])
        return nu_v, rho_v

    nu1, rho1 = phase("phase1")
    nu2, rho2 = phase("phase2")
    _, sigma = dimensioned_scalar(tp.get("sigma", 0.0))
    model = str(tp.get("phaseChangeTwoPhaseMixture", "SchnerrSauer"))
    coeffs = tp.get(model + "Coeffs", FoamDict())
    p_sat = _dim_scalar_of(tp, "pSat", _dim_scalar_of(coeffs, "pSat",
                                                      2300.0))
    pdict = case.pimple_controls("PIMPLE")
    flow = inter_mod.InterConfig(
        rho1=rho1, rho2=rho2, nu1=nu1, nu2=nu2, sigma=sigma,
        g=_read_gravity(case),
        c_alpha=float(pdict.get("cAlpha", 1.0)),
        n_alpha_subcycles=int(pdict.get("nAlphaSubCycles", 1)),
        n_correctors=int(pdict.get("nCorrectors", 3)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        p_controls=case.solver_controls("p_rgh"))
    cfg = ipc_mod.PhaseChangeConfig(
        flow=flow, model=model, p_sat=p_sat,
        n_bubbles=_dim_scalar_of(coeffs, "n", 1.6e13),
        d_nuc=_dim_scalar_of(coeffs, "dNuc", 2.0e-6),
        Cc=_dim_scalar_of(coeffs, "Cc", 1.0),
        Cv=_dim_scalar_of(coeffs, "Cv", 1.0),
        U_inf=_dim_scalar_of(coeffs, "UInf", 20.0),
        t_inf=_dim_scalar_of(coeffs, "tInf", 0.005))
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    alpha = None
    for nm in ("alpha1", "alpha.water", "alpha"):
        if os.path.exists(os.path.join(case.dir, "0", nm)):
            alpha = case.read_field(nm)
            break
    state = ipc_mod.initial_state(mesh, U, p_rgh, alpha, cfg)
    step = ipc_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: interPhaseChangeFoam ({model})\n")
    for t in case.time.loop():
        state, diag = step(state, jnp.asarray(t.current_dt,
                                              mesh.v.dtype))
        log.info(f"Time = {t.name}\n")
        log.info(f"Liquid phase volume fraction = "
                 f"{float(jnp.mean(state['alpha'].data)):.6g}  "
                 f"Min(alpha1) = {float(diag['alpha_min']):.4g}  "
                 f"Max(alpha1) = {float(diag['alpha_max']):.4g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["p_rgh"],
                               state["alpha"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p_rgh"], state["alpha"]])
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def _engine_extra_fields(mesh, state, spray):
    if not spray:
        return []
    from ..core.fields import vol_scalar

    return [vol_scalar(mesh, 0.0, name="Yvapour").with_data(
        state["Yv"])]


def _engine_foam(case, max_steps: Optional[int] = None,
                 combustion: bool = False, spray: bool = False) -> None:
    """engineFoam / coldEngineFoam (reference: applications/solvers/
    combustion/{engineFoam,coldEngineFoam}/ + src/engine/): in-cylinder
    compressible flow with slider-crank piston motion from
    constant/engineGeometry. controlDict times are CRANK-ANGLE DEGREES
    (reference: engineTime user time). The patch named `piston` is the
    moving crown; the opposite extreme of the cylinder axis is the
    head. engineFoam adds b-Xi heat release with ignition from
    constant/combustionProperties (ignitionStart CAD, location,
    diameter)."""
    import jax.numpy as jnp

    from ..core.fields import vol_scalar
    from ..mesh import engine as eng_mod
    from ..models import thermo as thermo_mod
    from . import engine as engine_solver

    geom_d = case.properties("engineGeometry")
    geom = eng_mod.from_dict(geom_d)
    if _dim_scalar_of(geom_d, "pistonLayers", 0.0) > 0.0 and not spray:
        # layerAdditionRemoval piston motion (reference: src/engine/
        # engineMesh + src/dynamicMesh/polyTopoChange/
        # layerAdditionRemoval, selected by a non-zero pistonLayers
        # entry as in the reference's engineGeometry)
        _engine_foam_layered(case, max_steps, combustion, geom, geom_d)
        return
    mesh = case.mesh
    th = thermo_mod.from_dict(
        case.properties("thermophysicalProperties"))
    U = case.read_field("U")
    p = case.read_field("p")
    T = case.read_field("T")

    # piston crown / head positions along the engine axis
    pist = mesh.patch("piston")
    cf = np.asarray(mesh.cf)
    z_piston0 = float(cf[pist.slice, geom.axis].mean())
    ax_all = cf[:, geom.axis]
    z_head = float(ax_all.max() if z_piston0 < ax_all.mean()
                   else ax_all.min())
    pts_fn, umesh_fn = eng_mod.piston_motion(geom, z_head=z_head,
                                             z_piston0=z_piston0)
    comb = (case.properties("combustionProperties")
            if combustion else FoamDict())

    # sprayEngineFoam: injected evaporating cloud riding the moving
    # mesh inside the jitted engine step (reference: applications/
    # solvers/lagrangian/sprayFoam/sprayEngineFoam/)
    spray_cfg = cloud = None
    if spray:
        import jax.numpy as _jnp

        from .. import lagrangian as lag
        from ..lagrangian import reactingcloud as rcloud

        try:
            props = case.properties("sprayCloudProperties")
        except Exception:
            try:
                props = case.properties("reactingCloud1Properties")
            except Exception:
                props = FoamDict()
        cp = props.get("constantProperties", FoamDict())
        rho0p = _dim_scalar_of(cp, "rho0", 700.0)
        d0 = _dim_scalar_of(cp, "d0", 50e-6)
        T0p = _dim_scalar_of(cp, "T0", 320.0)
        rho_f0 = float(np.asarray(p.data).mean()) / (
            th.R * float(np.asarray(T.data).mean()))
        lcfg = lag.CloudConfig(rho_f=rho_f0, mu_f=th.mu,
                               g=_read_gravity(case), solve_T=True,
                               cp_p=_dim_scalar_of(cp, "Cp0", 2000.0))
        inj_d = props.get("injection", FoamDict())
        c = np.asarray(mesh.c)
        apex_default = list(c.mean(axis=0))
        apex_default[geom.axis] = float(c[:, geom.axis].max())
        apex = inj_d.get("position", apex_default)
        direc_default = [0.0, 0.0, 0.0]
        direc_default[geom.axis] = -1.0
        direc = inj_d.get("direction", direc_default)
        inj = lag.cone_injection(
            mesh,
            [float(x) for x in np.asarray(apex,
                                          float).reshape(-1)[-3:]],
            [float(x) for x in np.asarray(direc,
                                          float).reshape(-1)[-3:]],
            half_angle_deg=_dim_scalar_of(inj_d, "coneAngle", 10.0),
            u_mag=_dim_scalar_of(inj_d, "Umag", 100.0), d0=d0,
            rho0=rho0p,
            rate=_dim_scalar_of(inj_d, "parcelsPerSecond", 20000.0))
        n_slots = int(_dim_scalar_of(props, "maxParcels", 512))
        cloud = lag.make_cloud(mesh, np.asarray(apex, float)
                               .reshape(1, 3), [0.0, 0.0, 0.0],
                               d0, rho0p, n_slots=n_slots, T0=T0p)
        # the seed parcel is a placeholder slot; deactivate it
        cloud = cloud._replace(active=_jnp.zeros_like(cloud.active))
        spray_cfg = engine_solver.SprayConfig(
            lcfg=lcfg,
            ecfg=rcloud.EvapConfig(
                K_evap=_dim_scalar_of(props, "Kevap", 1e-7),
                L_vap=_dim_scalar_of(cp, "Lvap", 3.5e5)),
            bcfg=rcloud.BreakupConfig(rho_f=rho_f0),
            inj=inj, bt=_jnp.asarray(lag.face_boundary_types(mesh)))

    cfg = engine_solver.EngineConfig(
        thermo=th, pts_fn=pts_fn, umesh_fn=umesh_fn,
        s_per_cad=1.0 / eng_mod.deg_per_sec(geom),
        spray=spray_cfg,
        n_correctors=int(case.pimple_controls("PIMPLE").get(
            "nCorrectors", 2)),
        p_ref_value=float(np.asarray(p.data).mean()),
        Su0=_dim_scalar_of(comb, "Su", 0.0) if combustion else 0.0,
        Xi=_dim_scalar_of(comb, "Xi", 2.0),
        q_comb=_dim_scalar_of(comb, "qComb", 2.0e6),
        Tu=_dim_scalar_of(comb, "Tu", 300.0),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"))
    b = None
    if combustion:
        try:
            b = case.read_field("b")
        except Exception:
            b = vol_scalar(mesh, 1.0, name="b")
    state = engine_solver.initial_state(case.poly_mesh, mesh, U, p,
                                        T, th, cfg, b=b, cloud=cloud)
    step = engine_solver.make_step(mesh, cfg)

    ign = comb.get("ignition", FoamDict()) if combustion else FoamDict()
    ign_start = _dim_scalar_of(ign, "start", 0.0)       # CAD
    ign_d = _dim_scalar_of(ign, "diameter", 0.02)
    loc = ign.get("location", None)
    ignited = not combustion or not isinstance(ign, FoamDict) or \
        "start" not in ign

    name = ("sprayEngineFoam" if spray else
            "engineFoam" if combustion else "coldEngineFoam")
    log.info(f"Starting loop: {name}, rpm {geom.rpm}, "
             f"theta0 {geom.theta0} CAD\n")
    for t in case.time.loop():
        theta = geom.theta0 + t.value     # controlDict time == CAD
        if combustion and not ignited and theta >= ign_start:
            # spark: burnt kernel around the ignition location
            # (reference: ignitionSite — here a one-shot host-side set)
            c = np.asarray(mesh.c)
            lc = (np.asarray([float(x) for x in loc])
                  if loc is not None else c.mean(axis=0))
            r = np.linalg.norm(c - lc[None, :], axis=1)
            bb = np.asarray(state["b"].data).copy()
            bb[r < 0.5 * ign_d] = 0.0
            state["b"] = state["b"].with_data(
                jnp.asarray(bb, mesh.v.dtype))
            state["b0"] = state["b"].data
            ignited = True
            log.info(f"Ignition at theta = {theta:.2f} CAD\n")
        state, diag = step(state, jnp.asarray(t.current_dt,
                                              mesh.v.dtype))
        log.info(f"Crank angle = {theta + t.current_dt:.6g} CAD\n"
                 f"p_mean = {float(diag['p_mean']):.6g}  "
                 f"T_mean = {float(diag['T_mean']):.6g}  "
                 f"V = {float(diag['V_total']):.6g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["p"], state["T"]]
                              + ([state["b"]] if combustion else [])
                              + _engine_extra_fields(mesh, state,
                                                     spray))
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p"], state["T"]]
                      + ([state["b"]] if combustion else [])
                      + _engine_extra_fields(mesh, state, spray))
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def _engine_foam_layered(case, max_steps: Optional[int],
                         combustion: bool, geom, geom_d) -> None:
    """engineFoam/coldEngineFoam with layer addition/removal: the CELL
    COUNT CHANGES during the run (reference: src/dynamicMesh/
    polyTopoChange/polyTopoChanger/layerAdditionRemoval driven by
    src/engine/engineMesh, selected by engineGeometry `pistonLayers`).

    Structure: each topology is one jitted chunk; when the piston
    layer passes the 0.5/1.5 x pistonLayers thickness bounds the mesh
    is re-extruded on the host (mesh/topo.py), rho/momentum/energy are
    remapped through the exact conservative slab-overlap matrix, and
    the step re-traces. Mass is conserved exactly across events."""
    from ..bc import factory as bc_factory
    from ..bc.patchfields import normalize_bcs
    from ..core import runtime
    from ..core.fields import VolField
    from ..io import fields as field_io
    from ..io import polymesh as pmesh_io
    from ..mesh import engine as eng_mod
    from ..mesh import to_device
    from ..mesh import topo as topo_mod
    from ..models import thermo as thermo_mod
    from . import engine as engine_solver

    th = thermo_mod.from_dict(
        case.properties("thermophysicalProperties"))
    h0 = _dim_scalar_of(geom_d, "pistonLayers", 0.0)
    pm0 = case.poly_mesh
    topo = topo_mod.analyze(pm0, geom.axis)
    pist = pm0.patch("piston")
    z_p = float(np.asarray(pm0.cf)[pist.slice, geom.axis].mean())
    side = (0 if abs(z_p - topo.planes[0])
            <= abs(z_p - topo.planes[-1]) else -1)

    # initial fields on the ORIGINAL cell order + their boundary specs
    names = ["U", "p", "T"] + (["b"] if combustion else [])
    t0 = case.latest_time_name()
    raw = {}
    specs = {}
    meta = {}
    for nm in names:
        path = os.path.join(case.dir, t0, nm)
        if not os.path.exists(path) and not os.path.exists(path + ".gz"):
            path = os.path.join(case.dir, "0", nm)
        try:
            d = field_io.load_field_dict(path)
        except Exception:
            if nm != "b":
                raise
            d = None
        if d is None:
            raw[nm] = np.ones(pm0.n_cells)
            specs[nm] = None
            meta[nm] = (0, None)
            continue
        f = field_io.read_field(path, case.mesh, name=nm)
        raw[nm] = np.asarray(f.data)
        specs[nm] = d["boundaryField"]
        meta[nm] = (f.rank, f.dims)

    # switch to slab-major layered ordering once; afterwards the
    # build() layout IS the layered layout (reorder = identity)
    for nm in names:
        raw[nm] = topo_mod.reorder_to_layers(topo, raw[nm])
    planes = topo.planes.copy()
    nB = topo.n_base

    def rebuild_mesh(new_planes):
        # NOTE: any future y_wall-carrying turbulence model on this
        # path must call mesh.walldist.refresh_wall_distance here (the
        # topology-change boundary); the per-cell wall-adjacency data
        # (mesh.wall_mask/wall_y) is rebuilt by case.mesh below.
        pm = topo_mod.build(topo, new_planes)
        case._poly = pm
        case._mesh = None
        return pm, case.mesh

    def mk_field(nm, mesh, data):
        rank, dims = meta[nm]
        dtype = mesh.v.dtype
        if specs[nm] is None:
            from ..core.fields import vol_scalar

            return vol_scalar(mesh, 1.0, name=nm)
        bcs = tuple(
            bc_factory.from_dict(specs[nm].match(p.name), p, rank,
                                 dtype, mesh=mesh, case_dir=case.dir,
                                 field_name=nm)
            for p in mesh.patches)
        data = jnp.asarray(data, dtype)
        if rank == 1 and data.ndim == 1:
            data = jnp.broadcast_to(data[None, :], (mesh.n_cells, 3))
        return VolField(data=data, bcs=normalize_bcs(mesh, bcs, rank),
                        name=nm, dims=dims)

    def mk_chunk(theta_abs, data):
        """Build mesh/state/step for the current planes at absolute
        crank angle theta_abs with cell data dict (slab-major)."""
        pm, mesh = rebuild_mesh(planes)
        pts_fn, umesh_fn = eng_mod.piston_layer_motion(
            geom, planes, side, theta_abs)
        cfg = engine_solver.EngineConfig(
            thermo=th, pts_fn=pts_fn, umesh_fn=umesh_fn,
            s_per_cad=1.0 / eng_mod.deg_per_sec(geom),
            n_correctors=int(case.pimple_controls("PIMPLE").get(
                "nCorrectors", 2)),
            p_ref_value=float(np.asarray(data["p"]).mean()),
            Su0=_dim_scalar_of(case.properties("combustionProperties"),
                               "Su", 0.0) if combustion else 0.0,
            p_controls=case.solver_controls("p"),
            u_controls=case.solver_controls("U"))
        U = mk_field("U", mesh, data["U"])
        p = mk_field("p", mesh, data["p"])
        T = mk_field("T", mesh, data["T"])
        b = mk_field("b", mesh, data["b"]) if combustion else None
        state = engine_solver.initial_state(pm, mesh, U, p, T, th,
                                            cfg, b=b)
        step = engine_solver.make_step(mesh, cfg)
        return pm, mesh, state, step

    theta = geom.theta0 + case.time.start_time
    data = {nm: raw[nm] for nm in names}
    pm, mesh, state, step = mk_chunk(theta, data)
    n_events = 0
    mesh_written_since_event = True
    log.info(f"Starting loop: "
             f"{'engineFoam' if combustion else 'coldEngineFoam'} "
             f"(layerAR), rpm {geom.rpm}, pistonLayers {h0}, "
             f"nCells {pm.n_cells}\n")

    for t in case.time.loop():
        state, diag = step(state, jnp.asarray(t.current_dt,
                                              mesh.v.dtype))
        theta = geom.theta0 + t.value + t.current_dt
        log.info(f"Crank angle = {theta:.6g} CAD\n"
                 f"p_mean = {float(diag['p_mean']):.6g}  "
                 f"T_mean = {float(diag['T_mean']):.6g}  "
                 f"V = {float(diag['V_total']):.6g}  "
                 f"mass = {float(diag['mass']):.8g}  "
                 f"nCells = {pm.n_cells}\n")

        # layerAdditionRemoval check at the step end: piston plane
        # coordinate from the slider-crank increment since last step
        ds = (float(eng_mod.piston_displacement(geom, theta))
              - float(eng_mod.piston_displacement(
                  geom, theta - t.current_dt)))
        zp = planes[0] - ds if side == 0 else planes[-1] + ds
        new_planes, changed = topo_mod.layer_ar(planes, zp, h0,
                                                side=side)
        if changed:
            # conservative rho / momentum / energy remap between the
            # step-end (moved) planes and the re-layered planes
            WT = topo_mod.slab_overlap_matrix(
                _moved(planes, zp, side), new_planes)
            rho = np.asarray(th.rho(state["p"].data,
                                    state["T"].data))
            Ud = np.asarray(state["U"].data)
            Td = np.asarray(state["T"].data)
            rho_h = topo_mod.remap_cells(WT, nB, rho)
            rhoU = topo_mod.remap_cells(WT, nB, rho[:, None] * Ud)
            rhoT = topo_mod.remap_cells(WT, nB, rho * Td)
            data = {"U": rhoU / rho_h[:, None],
                    "T": rhoT / rho_h,
                    "p": rho_h * getattr(th, "R", 287.0)
                    * (rhoT / rho_h)}
            if combustion:
                rhob = topo_mod.remap_cells(
                    WT, nB, rho * np.asarray(state["b"].data))
                data["b"] = rhob / rho_h
            planes = new_planes
            pm, mesh, state, step = mk_chunk(theta, data)
            n_events += 1
            mesh_written_since_event = False
            log.info(f"layerAR event: nCells -> {pm.n_cells} "
                     f"(layers {planes.shape[0] - 1})\n")
        else:
            planes = _moved(planes, zp, side)

        if t.write_time():
            case.write_fields(
                [state["U"], state["p"], state["T"]]
                + ([state["b"]] if combustion else []))
            if not mesh_written_since_event:
                pmesh_io.write(pm, os.path.join(case.dir, t.name,
                                                "polyMesh"))
                mesh_written_since_event = True
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p"], state["T"]]
                      + ([state["b"]] if combustion else []))
    case.final_state = {"state": state, "diag": diag,
                        "n_cells": pm.n_cells, "n_events": n_events}
    log.info("End\n")


def _moved(planes, zp, side):
    p = np.asarray(planes, dtype=np.float64).copy()
    p[0 if side == 0 else -1] = zp
    return p


def cold_engine_foam(case, max_steps: Optional[int] = None) -> None:
    _engine_foam(case, max_steps, combustion=False)


def engine_foam(case, max_steps: Optional[int] = None) -> None:
    _engine_foam(case, max_steps, combustion=True)


def spray_engine_foam(case, max_steps: Optional[int] = None) -> None:
    """sprayEngineFoam (reference: applications/solvers/lagrangian/
    sprayFoam/sprayEngineFoam/): the spray cloud of sprayFoam on the
    crank-angle engine mesh; b-Xi heat release engages when
    constant/combustionProperties exists."""
    comb = os.path.exists(case.const_path("combustionProperties"))
    _engine_foam(case, max_steps, combustion=comb, spray=True)


def sonic_dym_foam(case, max_steps: Optional[int] = None) -> None:
    """sonicDyMFoam (reference: applications/solvers/compressible/
    sonicFoam/sonicDyMFoam/): transonic pressure-based compressible
    flow on a solid-body moving mesh — the ALE engine solver
    (solvers/engine.py) with the transonic div(phid,p) pressure
    equation and motion from constant/dynamicMeshDict."""
    import jax.numpy as jnp

    from ..models import thermo as thermo_mod
    from . import engine as engine_solver

    mesh = case.mesh
    th = thermo_mod.from_dict(
        case.properties("thermophysicalProperties"))
    pts_fn, umesh_fn = _dym_motion(case)
    cdict = case.pimple_controls("PIMPLE")
    U = case.read_field("U")
    p = case.read_field("p")
    T = case.read_field("T")
    cfg = engine_solver.EngineConfig(
        thermo=th, pts_fn=pts_fn, umesh_fn=umesh_fn, s_per_cad=1.0,
        n_correctors=int(cdict.get("nCorrectors", 2)),
        p_ref_value=float(np.asarray(p.data).mean()),
        transonic=True,
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"))
    state = engine_solver.initial_state(case.poly_mesh, mesh, U, p, T,
                                        th, cfg)
    step = engine_solver.make_step(mesh, cfg)
    log.info("Starting loop: sonicDyMFoam\n")
    for t in case.time.loop():
        state, diag = step(state, jnp.asarray(t.current_dt,
                                              mesh.v.dtype))
        log.info(f"Time = {t.name}\np_mean = "
                 f"{float(diag['p_mean']):.6g}  T_mean = "
                 f"{float(diag['T_mean']):.6g}\n")
        if t.write_time():
            case.write_fields([state["U"], state["p"], state["T"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p"], state["T"]])
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def dsmc_foam(case, max_steps: Optional[int] = None) -> None:
    """dsmcFoam (reference: applications/solvers/discreteMethods/dsmc/
    dsmcFoam/): VHS direct-simulation Monte Carlo. Reads
    constant/dsmcProperties (nEquivalentParticles + moleculeProperties
    per species) and system/dsmcInitialiseDict (numberDensities /
    temperature / velocity — the reference's dsmcInitialise utility is
    folded into the solver start-up when no cloud exists yet); writes
    sampled rhoN/U/T fields at write times."""
    import jax
    import jax.numpy as jnp

    from .. import lagrangian as lag
    from ..lagrangian import dsmc
    from ..bc.patchfields import default_bcs
    from ..core.dimensions import DimensionSet
    from ..core.fields import VolField

    mesh = case.mesh
    props = case.properties("dsmcProperties")
    fn = _dim_scalar_of(props, "nEquivalentParticles", 1e12)
    mol = props.get("moleculeProperties", FoamDict())
    names, mass, dref, omega, tref = [], [], [], [], 273.0
    for k, v in mol.items():
        if isinstance(v, FoamDict):
            names.append(k)
            mass.append(_dim_scalar_of(v, "mass", 6.63e-26))
            dref.append(_dim_scalar_of(v, "diameter", 4.17e-10))
            omega.append(_dim_scalar_of(v, "omega", 0.81))
            tref = _dim_scalar_of(v, "Tref", tref)
    if not names:
        names, mass, dref, omega = ["Ar"], [6.63e-26], [4.17e-10], [0.81]
    species = dsmc.Species(mass=jnp.asarray(mass),
                           d_ref=jnp.asarray(dref),
                           omega=jnp.asarray(omega), T_ref=tref)
    init_path = os.path.join(case.dir, "system", "dsmcInitialiseDict")
    init = (parse_file(init_path) if os.path.exists(init_path)
            else FoamDict())
    nds = init.get("numberDensities", FoamDict())
    nd_by_sp = [ _dim_scalar_of(nds, n, 0.0) for n in names ]
    nd_tot = sum(nd_by_sp) or 1e20
    fracs = ([x / nd_tot for x in nd_by_sp] if sum(nd_by_sp) > 0
             else None)
    T0 = _dim_scalar_of(init, "temperature", 300.0)
    U0v = init.get("velocity", [0.0, 0.0, 0.0])
    U0 = tuple(float(x) for x in np.asarray(U0v, float).reshape(-1)[-3:])
    cloud = dsmc.initialise(mesh, species, nd_tot, T0, U0, fn,
                            typ_fracs=fracs)
    bt = jnp.asarray(lag.face_boundary_types(mesh))
    cfg = dsmc.DsmcConfig(nEquivalentParticles=fn)
    step = jax.jit(lambda c, dt: dsmc.evolve(mesh, c, dt, bt, cfg,
                                             species))
    sample = jax.jit(lambda c: dsmc.sample_fields(mesh, c, species, fn))

    def write(t):
        f = sample(cloud)
        flds = [
            VolField(data=f["rhoN"], bcs=default_bcs(mesh, 0),
                     name="rhoN", dims=DimensionSet.of(0, -3, 0)),
            VolField(data=f["T"], bcs=default_bcs(mesh, 0),
                     name="overallT", dims=DimensionSet.of(0, 0, 0, 1)),
            VolField(data=f["U"], bcs=default_bcs(mesh, 3),
                     name="overallU", dims=DimensionSet.of(0, 1, -1)),
        ]
        case.write_fields(flds, time_name=t.name)

    log.info(f"Starting loop: dsmcFoam, {int(cloud.n_active)} "
             f"parcels, {len(names)} species\n")
    for t in case.time.loop():
        cloud = step(cloud, jnp.asarray(t.current_dt, mesh.v.dtype))
        log.info(f"Time = {t.name}\n    Number of dsmc particles = "
                 f"{int(cloud.n_active)}\n")
        if t.write_time():
            write(t)
        if max_steps is not None and t.index >= max_steps:
            break
    write(case.time)
    case.final_state = {"cloud": cloud,
                        "fields": {k: v for k, v in sample(cloud).items()}}
    log.info("End\n")


def _md_setup(case):
    """Shared mdFoam/mdEquilibrationFoam setup: LJ molecule properties
    from constant/moleculeProperties, lattice fill from
    system/mdInitialiseDict, periodic box = mesh bounding box."""
    from ..lagrangian import md

    mesh = case.mesh
    props = case.properties("moleculeProperties")
    eps = _dim_scalar_of(props, "epsilon", 1.656e-21)
    sig = _dim_scalar_of(props, "sigma", 3.4e-10)
    m = _dim_scalar_of(props, "mass", 6.63e-26)
    rcut = _dim_scalar_of(props, "rCut", 2.5 * sig)
    # domain bounds from the face centres (boundary faces included;
    # exact for the box domains MD uses)
    pts = np.asarray(mesh.cf)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    cfg = md.MdConfig(epsilon=eps, sigma=sig, mass=m,
                      box=tuple(float(x) for x in (hi - lo)),
                      r_cut=rcut)
    init_path = os.path.join(case.dir, "system", "mdInitialiseDict")
    init = (parse_file(init_path) if os.path.exists(init_path)
            else FoamDict())
    n_side = int(_dim_scalar_of(init, "nSide", 5))
    T0 = _dim_scalar_of(init, "temperature", 120.0)
    x, u = md.lattice_fill(cfg.box, n_side, mass=m, T0=T0)
    x = x + lo[None, :]
    return md, cfg, md.make_state(x, u, cfg), init


def md_foam(case, max_steps: Optional[int] = None) -> None:
    """mdFoam (reference: applications/solvers/discreteMethods/
    molecularDynamics/mdFoam/): NVE Lennard-Jones molecular dynamics,
    velocity-Verlet integration, periodic box."""
    import jax
    import jax.numpy as jnp

    md, cfg, state, _ = _md_setup(case)
    step = jax.jit(lambda s, dt: md.verlet_step(s, dt, cfg))
    log.info(f"Starting loop: mdFoam, {state.x.shape[0]} molecules\n")
    pot = 0.0
    for t in case.time.loop():
        state, pot = step(state, jnp.asarray(t.current_dt,
                                             state.x.dtype))
        T = float(md.temperature(state, cfg))
        E = float(md.kinetic_energy(state, cfg)) + float(pot)
        log.info(f"Time = {t.name}\n    temperature = {T:.6g} K, "
                 f"total energy = {E:.6g} J\n")
        if max_steps is not None and t.index >= max_steps:
            break
    case.final_state = {"state": state, "T": float(md.temperature(
        state, cfg)), "E": float(md.kinetic_energy(state, cfg))
        + float(pot)}
    log.info("End\n")


def md_equilibration_foam(case, max_steps: Optional[int] = None) -> None:
    """mdEquilibrationFoam (reference: applications/solvers/
    discreteMethods/molecularDynamics/mdEquilibrationFoam/): mdFoam +
    velocity rescaling toward targetTemperature each step."""
    import jax
    import jax.numpy as jnp

    md, cfg, state, init = _md_setup(case)
    T_tgt = _dim_scalar_of(init, "targetTemperature",
                           _dim_scalar_of(init, "temperature", 120.0))
    step = jax.jit(lambda s, dt: md.equilibrate_step(
        s, dt, cfg, T_tgt, relax=0.1))
    log.info(f"Starting loop: mdEquilibrationFoam, "
             f"{state.x.shape[0]} molecules, target {T_tgt} K\n")
    for t in case.time.loop():
        state, _ = step(state, jnp.asarray(t.current_dt, state.x.dtype))
        log.info(f"Time = {t.name}\n    temperature = "
                 f"{float(md.temperature(state, cfg)):.6g} K\n")
        if max_steps is not None and t.index >= max_steps:
            break
    case.final_state = {"state": state,
                        "T": float(md.temperature(state, cfg))}
    log.info("End\n")


def dns_foam(case, max_steps: Optional[int] = None) -> None:
    """dnsFoam (reference: applications/solvers/DNS/dnsFoam/): direct
    simulation of isotropic box turbulence — icoFoam's PISO loop plus
    a spectral UO-process forcing field regenerated on the host each
    step (reference: forceGen = Kmesh + UOprocess; here
    models/randomprocesses.UOProcess projected divergence-free on a
    small set of low-wavenumber modes)."""
    import jax
    import jax.numpy as jnp

    from ..models import randomprocesses as rp

    mesh = case.mesh
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    U = case.read_field("U")
    p = case.read_field("p")
    pdict = case.pimple_controls("PISO")
    cfg = piso_mod.PisoConfig(
        nu=nu,
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        div_scheme=case.div_scheme("div(phi,U)"),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
    )
    state = piso_mod.initial_state(mesh, U, p, ddt_scheme="Euler")
    step = piso_mod.make_step(mesh, cfg)

    # low-wavenumber forcing modes (first shell of the box)
    c = np.asarray(mesh.c)
    lo, hi = c.min(axis=0), c.max(axis=0)
    L = np.maximum(hi - lo, 1e-30)
    k1 = 2 * np.pi / L
    kvecs = []
    for kx in (-1, 0, 1):
        for ky in (-1, 0, 1):
            for kz in (-1, 0, 1):
                if (kx, ky, kz) != (0, 0, 0):
                    kvecs.append([kx * k1[0], ky * k1[1], kz * k1[2]])
    kvecs = np.asarray(kvecs)
    uo = rp.UOProcess(len(kvecs), alpha=0.81, sigma=0.09, seed=1)
    phase = c @ kvecs.T                       # [nC, nK]
    cosk = np.cos(phase)
    sink = np.sin(phase)
    khat = kvecs / np.linalg.norm(kvecs, axis=1, keepdims=True)

    def force_field(dt):
        w = uo.update(dt)                     # [nK,3] complex
        # project each mode divergence-free: w -= (w.khat) khat
        w = w - khat * np.einsum("kd,kd->k", w.real, khat)[:, None] \
            - 1j * khat * np.einsum("kd,kd->k", w.imag, khat)[:, None]
        f = cosk @ w.real + sink @ w.imag     # [nC,3]
        return jnp.asarray(f, mesh.v.dtype)

    log.info(f"Starting time loop: dnsFoam, {mesh.n_cells} cells\n")
    cumulative = 0.0
    for t in case.time.loop():
        dt = jnp.asarray(t.current_dt, mesh.v.dtype)
        # forcing enters as a body force via the fvOptions-style source:
        # U += dt * f after the PISO step (explicit, as the reference
        # adds force to UEqn each step)
        state, diag = step(state, dt)
        f = force_field(float(t.current_dt))
        Unew = state["U"].with_data(state["U"].data + dt * f)
        state = dict(state)
        state["U"] = Unew
        cumulative = _log_step(case, t, diag, cumulative)
        k_tke = 0.5 * float(jnp.mean(jnp.sum(state["U"].data ** 2,
                                             axis=1)))
        log.info(f"k = {k_tke:.6g}\n")
        if t.write_time():
            _write_state(case, state)
        if max_steps is not None and t.index >= max_steps:
            break
    _write_state(case, state)
    log.info("End\n")
    case.final_state = state


def shallow_water_foam(case, max_steps: Optional[int] = None) -> None:
    """shallowWaterFoam (reference: applications/solvers/shallowWater/).
    Reads constant/gravitationalProperties (magg, rotating, Omega),
    0/{h,hU} and 0/h0 (bed elevation, optional)."""
    import jax.numpy as jnp

    from . import shallowwater as sw_mod

    mesh = case.mesh
    try:
        gp = case.properties("gravitationalProperties")
    except (OSError, IOError):
        gp = FoamDict()
    magg = _dim_scalar_of(gp, "magg", 9.81)
    rotating = str(gp.get("rotating", "no")) in ("yes", "true", "on")
    om = gp.get("Omega")
    omega = (0.0, 0.0, 0.0)
    if isinstance(om, list):
        v = np.asarray(om[-1] if isinstance(om[-1], (list, np.ndarray))
                       else om, dtype=float).reshape(-1)[-3:]
        omega = (float(v[0]), float(v[1]), float(v[2]))
    h = case.read_field("h")
    hU = case.read_field("hU")
    try:
        h0 = np.asarray(case.read_field("h0").data)
    except (OSError, IOError):
        h0 = np.zeros(mesh.n_cells)
    pdict = case.pimple_controls("PIMPLE")
    cfg = sw_mod.ShallowWaterConfig(
        g=magg, rotating=rotating, omega=omega,
        n_outer=int(pdict.get("nOuterCorrectors", 1)),
        n_correctors=int(pdict.get("nCorrectors", 2)),
        n_non_orth=int(pdict.get("nNonOrthogonalCorrectors", 0)),
        div_scheme=case.div_scheme("div(phiv,hU)"),
        h_controls=case.solver_controls("h"),
        hu_controls=case.solver_controls("hU"),
    )
    state = sw_mod.initial_state(mesh, h, hU, h0)
    step = sw_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: shallowWaterFoam, {mesh.n_cells} cells\n")
    cumulative = 0.0
    for t in case.time.loop():
        state, diag = step(state, jnp.asarray(t.current_dt, mesh.v.dtype))
        cumulative = _log_step(case, t, diag, cumulative)
        t.adjust_delta_t(float(diag["courant_max"]))
        if t.write_time():
            case.write_fields([state["h"], state["hU"], state["U"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["h"], state["hU"], state["U"]])
    log.info("End\n")
    case.final_state = state


def _solid_run(case, steady: bool, max_steps: Optional[int]) -> None:
    """solidDisplacementFoam / solidEquilibriumDisplacementFoam driver
    (reference: applications/solvers/stressAnalysis/)."""
    import jax.numpy as jnp

    from . import soliddisplacement as sd_mod

    mesh = case.mesh
    mp = case.properties("mechanicalProperties")
    rho = _dim_scalar_of(mp, "rho", 7854.0)
    E = _dim_scalar_of(mp, "E", 2e11)
    nu = _dim_scalar_of(mp, "nu", 0.3)
    plane_stress = str(mp.get("planeStress", "no")) in ("yes", "true",
                                                        "on", "1")
    try:
        thp = case.properties("thermalProperties")
    except (OSError, IOError):
        thp = FoamDict()
    if str(thp.get("thermalStress", "no")) in ("yes", "true", "on"):
        raise NotImplementedError(
            "thermalStress coupling not implemented yet")
    D = case.read_field("D")
    # traction/pressure specs from the raw 0/D boundaryField
    from ..bc.factory import parse_value

    raw = parse_file(os.path.join(case.dir, "0", "D"))
    bf = raw.get("boundaryField", FoamDict())
    dtype = np.asarray(mesh.v).dtype
    traction = []
    for patch in mesh.patches:
        spec = bf.get(patch.name) if isinstance(bf, FoamDict) else None
        if (isinstance(spec, FoamDict)
                and str(spec.get("type")) == "tractionDisplacement"):
            tv = parse_value(spec.get("traction"), patch.size, 1, dtype)
            pv = parse_value(spec.get("pressure"), patch.size, 0, dtype)
            tv = np.zeros(3) if tv is None else np.asarray(tv, float)
            pv = 0.0 if pv is None else np.asarray(pv, float)
            traction.append((tv / rho, pv / rho))
        else:
            traction.append(None)
    sdict = case.pimple_controls("stressAnalysis")
    cfg = sd_mod.SolidConfig(
        rho=rho, E=E, nu=nu, plane_stress=plane_stress, steady=steady,
        n_corr=max(int(sdict.get("nCorrectors", 1)), 1),
        tolerance=float(sdict.get("D", 1e-6)),
        d_controls=case.solver_controls("D"),
        traction=tuple(traction))
    state = sd_mod.initial_state(mesh, D, steady=steady)
    step = sd_mod.make_step(mesh, cfg)
    name = ("solidEquilibriumDisplacementFoam" if steady
            else "solidDisplacementFoam")
    log.info(f"Starting loop: {name}, {mesh.n_cells} cells\n")
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(1.0 if steady else t.delta_t, mesh.v.dtype)
    cumulative = 0.0
    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        log.info(f"Time = {t.name}\n")
        log.info(log.solver_line("Dx", diag["D"]))
        if t.write_time():
            case.write_fields([state["D"]])
        res = float(np.max(np.asarray(diag["D"].initial_residual)))
        if steady and res < cfg.tolerance:
            log.info(f"Converged in {t.index} iterations\n")
            break
    case.write_fields([state["D"]])
    log.info("End\n")
    case.final_state = state


def solid_displacement_foam(case, max_steps: Optional[int] = None):
    _solid_run(case, steady=False, max_steps=max_steps)


def solid_equilibrium_displacement_foam(case,
                                        max_steps: Optional[int] = None):
    _solid_run(case, steady=True, max_steps=max_steps)


def _rho_pimple_run(case, steady: bool, transonic: bool,
                    max_steps: Optional[int],
                    consistent: bool = False) -> None:
    """Shared driver for rhoSimpleFoam / rhoPimpleFoam / sonicFoam
    (reference: applications/solvers/compressible/)."""
    import jax.numpy as jnp

    from ..models import thermo as thermo_mod
    from . import rhopimple as rp_mod

    mesh = case.mesh
    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    model, tstate = _load_turbulence(case, max(th.mu, 1e-12),
                                     compressible=True)
    relax = _relaxation(case)
    cname = "SIMPLE" if steady else "PIMPLE"
    cdict = case.pimple_controls(cname)
    try:
        pf_ctl = case.solver_controls("pFinal")
    except KeyError:
        pf_ctl = None
    cfg = rp_mod.RhoPimpleConfig(
        thermo=th,
        steady=steady,
        consistent=consistent,
        transonic=transonic or str(cdict.get("transonic", "no")) in (
            "yes", "true", "on", "1"),
        n_outer=int(cdict.get("nOuterCorrectors", 1)),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        div_scheme_e=case.div_scheme("div(phi,e)"),
        ddt_scheme=case.ddt_scheme(),
        grad_scheme=case.grad_scheme("grad(p)"),
        alpha_u=relax.get("U", 0.7 if steady else 1.0),
        alpha_p=relax.get("p", 0.3 if steady else 1.0),
        alpha_e=relax.get("e", relax.get("h", 0.7 if steady else 1.0)),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        p_ref_value=float(cdict.get("pRefValue", 1e5)),
        p_controls=case.solver_controls("p"),
        p_controls_final=pf_ctl,
        u_controls=case.solver_controls("U"),
        e_controls=case.solver_controls("T") if _has_solver(case, "T")
        else None,
        turb=model,
        turb_relax=relax.get("k", 0.7),
        fv_options=_load_fvoptions(case, th.mu),
        mrf=_load_mrf(case),
    )
    U = case.read_field("U")
    p = case.read_field("p")
    T = case.read_field("T")
    if cfg.mrf:
        U = cfg.mrf.correct_boundary_velocity(mesh, U)
    state = rp_mod.initial_state(mesh, U, p, T, th, turb_state=tstate,
                                 steady=steady)
    if cfg.mrf:
        # initial MASS flux -> relative frame (rho-weighted correction)
        from ..ops import slot as slot_mod, surface as surf_mod

        rho_c = th.rho(p.data, T.data)
        rho_slot = slot_mod.interpolate(
            mesh, rho_c, bv=surf_mod.owner_to_b(mesh, rho_c))
        sl = cfg.mrf.make_relative(
            mesh, slot_mod.from_flat(mesh, state["phi"]),
            rho_slot=rho_slot)
        state["phi"] = slot_mod.to_flat(mesh, sl)
        state["phi_slot"] = (sl.sv, sl.fb)
    if cfg.fv_options:
        state["fvopt"] = cfg.fv_options.init_state(mesh)
    step = rp_mod.make_step(mesh, cfg)
    res_ctl = _residual_control(case, cname)
    name = ("rhoSimpleFoam" if steady
            else ("sonicFoam" if cfg.transonic else "rhoPimpleFoam"))
    log.info(f"Starting loop: {name}, {mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(1.0 if steady else t.delta_t, mesh.v.dtype)
    from ..functionobjects import make_function_objects

    fol = make_function_objects(case)

    def write(state):
        fields = [state["U"], state["p"], state["T"]]
        if "turb" in state and state["turb"]:
            fields += list(state["turb"].values())
        case.write_fields(fields)

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        log.info(log.solver_line("T", diag["T"]))
        fol.execute(t.name, state)
        if t.write_time():
            write(state)
        if steady and simple_mod.converged(diag, res_ctl):
            log.info(f"SIMPLE solution converged in {t.index} iterations\n")
            break
    write(state)
    log.info("End\n")
    case.final_state = state


def _has_solver(case, name) -> bool:
    try:
        case.solver_controls(name)
        return True
    except KeyError:
        return False


def multiphase_inter_foam(case, max_steps: Optional[int] = None) -> None:
    """multiphaseInterFoam: N immiscible phases with pairwise MULES
    compression (reference: applications/solvers/multiphase/
    multiphaseInterFoam/). Phases from constant/transportProperties
    `phases (name1 name2 ...)` with per-phase subdicts {rho, nu} and
    `sigmas ((a b s) ...)`; fractions read from 0/alpha<name>."""
    import dataclasses as _dc

    from ..core.fields import VolField
    from . import multiphaseinter as mpi_mod

    mesh = case.mesh
    tp = case.transport_properties()
    names = [str(x) for x in tp.get("phases", [])]
    if not names:
        raise ValueError("multiphaseInterFoam needs transportProperties"
                         " `phases (...)`")
    rhos, nus = [], []
    for n in names:
        ph = tp.get(n, FoamDict())
        rhos.append(_dim_scalar_of(ph, "rho", 1000.0))
        nus.append(_dim_scalar_of(ph, "nu", 1e-6))
    sigmas = {}
    for row in tp.get("sigmas", []) or []:
        try:
            arr = np.asarray(row, dtype=float).ravel()
            if arr.size == 3:
                sigmas[(int(arr[0]), int(arr[1]))] = float(arr[2])
        except (TypeError, ValueError):
            continue
    flds = [case.read_field(f"alpha{n}") for n in names]
    A = jnp.stack([f.data for f in flds], axis=1)
    alphas = VolField(data=A, bcs=flds[0].bcs, name="alphas")
    cdict = case.pimple_controls("PIMPLE")
    cfg = mpi_mod.MultiphaseConfig(
        rhos=tuple(rhos), nus=tuple(nus), sigmas=sigmas,
        g=_read_gravity(case),
        c_alpha=float(cdict.get("cAlpha", 1.0)),
        n_correctors=int(cdict.get("nCorrectors", 3)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_controls=case.solver_controls("p_rgh")
        if _has_solver(case, "p_rgh") else case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        mrf=_load_mrf(case))
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    state = mpi_mod.initial_state(mesh, U, p_rgh, alphas, cfg)
    step = mpi_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: multiphaseInterFoam, {mesh.n_cells} "
             f"cells, phases {names}\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)

    def write(state):
        A = state["alphas"]
        fields = [state["U"], state["p_rgh"]]
        for i, n in enumerate(names):
            fields.append(_dc.replace(flds[i], data=A.data[:, i],
                                      name=f"alpha{n}"))
        case.write_fields(fields)

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def two_liquid_mixing_foam(case, max_steps: Optional[int] = None) -> None:
    """twoLiquidMixingFoam: two miscible incompressible liquids
    (reference: applications/solvers/multiphase/twoLiquidMixingFoam/).
    Phase properties from constant/transportProperties phase1/phase2
    (rho, nu) + Dab."""
    from . import twoliquidmixing as tlm_mod

    mesh = case.mesh
    tp = case.transport_properties()
    ph1 = tp.get("phase1", FoamDict())
    ph2 = tp.get("phase2", FoamDict())
    cdict = case.pimple_controls("PIMPLE")
    cfg = tlm_mod.TwoLiquidConfig(
        rho1=_dim_scalar_of(ph1, "rho", 1010.0),
        rho2=_dim_scalar_of(ph2, "rho", 1000.0),
        nu1=_dim_scalar_of(ph1, "nu", 1e-6),
        nu2=_dim_scalar_of(ph2, "nu", 1e-6),
        Dab=_dim_scalar_of(tp, "Dab", 1e-6),
        g=_read_gravity(case),
        n_correctors=int(cdict.get("nCorrectors", 3)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_controls=case.solver_controls("p_rgh")
        if _has_solver(case, "p_rgh") else case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        a_controls=case.solver_controls("alpha")
        if _has_solver(case, "alpha") else None,
    )
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    try:
        alpha = case.read_field("alpha")
    except Exception:
        alpha = case.read_field("alpha1")
    state = tlm_mod.initial_state(mesh, U, p_rgh, alpha, cfg)
    step = tlm_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: twoLiquidMixingFoam, "
             f"{mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)

    def write(state):
        case.write_fields([state["U"], state["p_rgh"], state["alpha"]])

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def two_phase_euler_foam(case, max_steps: Optional[int] = None) -> None:
    """twoPhaseEulerFoam: Euler-Euler two-phase flow with drag
    coupling (reference: applications/solvers/multiphase/
    twoPhaseEulerFoam/). Phase properties from constant/
    transportProperties `phasea`/`phaseb` entries (rho, nu, d);
    Schiller-Naumann drag (constant/interfacialProperties is accepted
    but only SchillerNaumann is implemented — documented)."""
    from . import twophaseeuler as tpe_mod

    mesh = case.mesh
    tp = case.transport_properties()
    pa = tp.get("phasea", tp.get("phase1", FoamDict()))
    pb = tp.get("phaseb", tp.get("phase2", FoamDict()))
    cdict = case.pimple_controls("PIMPLE")
    cfg = tpe_mod.TwoPhaseConfig(
        rhoa=_dim_scalar_of(pa, "rho", 1.2),
        rhob=_dim_scalar_of(pb, "rho", 1000.0),
        nua=_dim_scalar_of(pa, "nu", 1.5e-5),
        nub=_dim_scalar_of(pb, "nu", 1e-6),
        d_a=_dim_scalar_of(pa, "d", 3e-3),
        g=_read_gravity(case),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        p_ref_value=float(cdict.get("pRefValue", 0.0)),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U")
        if _has_solver(case, "U") else case.solver_controls("Ua"),
    )
    Ua = case.read_field("Ua")
    Ub = case.read_field("Ub")
    p = case.read_field("p")
    alpha = case.read_field("alpha")
    state = tpe_mod.initial_state(mesh, Ua, Ub, p, alpha)
    step = tpe_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: twoPhaseEulerFoam, {mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)

    def write(state):
        case.write_fields([state["Ua"], state["Ub"], state["p"],
                           state["alpha"]])

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        log.info(f"Time = {t.name}\n")
        log.info(
            f"Min(alpha) = {float(diag['alpha_min']):.6g}  "
            f"Max(alpha) = {float(diag['alpha_max']):.6g}\n")
        cumulative = _log_step(case, t, diag, cumulative)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def multiphase_euler_foam(case, max_steps: Optional[int] = None) -> None:
    """multiphaseEulerFoam: N interpenetrating phases, each with its
    own velocity, pairwise blended drag, shared pressure (reference:
    applications/solvers/multiphase/multiphaseEulerFoam/). Phases from
    constant/transportProperties `phases (name {rho; nu; d;} ...)` or
    `phases (name1 name2 ...)` with per-phase subdicts; fractions
    from 0/alpha<name>, velocities from 0/U<name> (falling back to a
    shared 0/U)."""
    import dataclasses as _dc

    from ..core.fields import VolField
    from . import multiphaseeuler as mpe_mod

    mesh = case.mesh
    tp = case.transport_properties()
    raw = tp.get("phases", [])
    names, rhos, nus, ds = [], [], [], []
    # two accepted layouts: inline subdicts inside the phases list, or
    # a bare name list with top-level per-phase subdicts
    idx = 0
    while idx < len(raw):
        n = str(raw[idx])
        ph = FoamDict()
        if idx + 1 < len(raw) and isinstance(raw[idx + 1],
                                             (dict, FoamDict)):
            ph = raw[idx + 1]
            idx += 2
        else:
            ph = tp.get(n, FoamDict())
            idx += 1
        names.append(n)
        rhos.append(_dim_scalar_of(ph, "rho", 1000.0))
        nus.append(_dim_scalar_of(ph, "nu", 1e-6))
        d_val = ph.get("d", None)
        if d_val is None:
            cc = ph.get("constantCoeffs", FoamDict())
            d_val = cc.get("d", 1e-3)
        _, d_num = dimensioned_scalar(d_val)
        ds.append(d_num)
    if not names:
        raise ValueError("multiphaseEulerFoam needs transportProperties"
                         " `phases (...)`")
    flds = [case.read_field(f"alpha{n}") for n in names]
    A = jnp.stack([f.data for f in flds], axis=1)
    alphas = VolField(data=A, bcs=flds[0].bcs, name="alphas")
    Us = []
    for n in names:
        try:
            Us.append(case.read_field(f"U{n}"))
        except Exception:
            Us.append(case.read_field("U"))
    p = case.read_field("p")
    cdict = case.pimple_controls("PIMPLE")
    cfg = mpe_mod.MultiphaseEulerConfig(
        rhos=tuple(rhos), nus=tuple(nus), ds=tuple(ds),
        g=_read_gravity(case),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        p_ref_value=float(cdict.get("pRefValue", 0.0)),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U")
        if _has_solver(case, "U") else None)
    state = mpe_mod.initial_state(mesh, Us, p, alphas)
    step = mpe_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: multiphaseEulerFoam, {mesh.n_cells} "
             f"cells, phases {names}\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)

    def write(state):
        Adata = state["alphas"].data
        fields = [state["p"]]
        for i, n in enumerate(names):
            fields.append(_dc.replace(flds[i], data=Adata[:, i],
                                      name=f"alpha{n}"))
            fields.append(_dc.replace(state[f"U{i}"], name=f"U{n}"))
        case.write_fields(fields)

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def compressible_inter_foam(case, max_steps: Optional[int] = None) -> None:
    """compressibleInterFoam: two compressible phases + MULES VOF
    (reference: applications/solvers/multiphase/compressibleInterFoam/).
    Phase EOS from constant/thermophysicalProperties `phase1`
    (perfectGas: R, Cv, nu) / `phase2` (perfectFluid: R, rho0, Cv, nu);
    sigma + g from constant/{transportProperties,g}."""
    from . import compressibleinter as ci_mod

    mesh = case.mesh
    th = case.properties("thermophysicalProperties")
    ph1 = th.get("phase1", FoamDict())
    ph2 = th.get("phase2", FoamDict())
    tp = case.transport_properties()
    _, sigma = dimensioned_scalar(tp.get("sigma", 0.07))
    gvec = _read_gravity(case)
    cdict = case.pimple_controls("PIMPLE")
    cfg = ci_mod.CompIntConfig(
        R1=_dim_scalar_of(ph1, "R", 287.0),
        R2=_dim_scalar_of(ph2, "R", 3000.0),
        rho0_2=_dim_scalar_of(ph2, "rho0", 1000.0),
        nu1=_dim_scalar_of(ph1, "nu", 1.5e-5),
        nu2=_dim_scalar_of(ph2, "nu", 1e-6),
        Cv1=_dim_scalar_of(ph1, "Cv", 718.0),
        Cv2=_dim_scalar_of(ph2, "Cv", 4186.0),
        sigma=sigma, g=gvec,
        c_alpha=float(cdict.get("cAlpha", 1.0)),
        n_alpha_subcycles=int(cdict.get("nAlphaSubCycles", 1)),
        n_correctors=int(cdict.get("nCorrectors", 3)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        p_min=float(th.get("pMin", [0, 1000.0])[-1]
                    if isinstance(th.get("pMin"), (list, tuple))
                    else th.get("pMin", 1000.0)),
        p_controls=case.solver_controls("p_rgh")
        if _has_solver(case, "p_rgh") else case.solver_controls("p"),
        u_controls=case.solver_controls("U"),
        t_controls=case.solver_controls("T") if _has_solver(case, "T")
        else None,
    )
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    T = case.read_field("T")
    try:
        alpha = case.read_field("alpha1")
    except Exception:
        alpha = case.read_field("alpha")
    state = ci_mod.initial_state(mesh, U, p_rgh, T, alpha, cfg)
    step = ci_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: compressibleInterFoam, "
             f"{mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)

    def write(state):
        case.write_fields([state["U"], state["p_rgh"], state["T"],
                           state["alpha"]])

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        log.info(f"Time = {t.name}\n")
        log.info(
            "Phase-1 volume fraction = "
            f"{float(jnp.mean(state['alpha'].data)):.6g}  "
            f"Min(alpha1) = {float(diag['alpha_min']):.6g}  "
            f"Max(alpha1) = {float(diag['alpha_max']):.6g}\n")
        cumulative = _log_step(case, t, diag, cumulative)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def _pimple_dym_sixdof(case, dmd, max_steps: Optional[int]) -> None:
    """pimpleDyMFoam with the sixDoFRigidBodyMotion motion solver
    (reference: src/sixDoFRigidBodyMotion + the floatingObject
    tutorial pattern): flow forces on the body patch drive the rigid
    body; the mesh blends with the body motion (solvers/floating.py).
    dynamicMeshDict keys: sixDoFRigidBodyMotionCoeffs { patch; mass;
    momentOfInertia; centreOfMass; innerDistance; outerDistance;
    rhoInf; restraints { ... linearSpring ... } }."""
    import jax.numpy as jnp

    from ..models import sixdof
    from . import floating as fl_mod

    mesh = case.mesh
    tp = case.transport_properties()
    _, nu = dimensioned_scalar(tp["nu"])
    co = dmd.get("sixDoFRigidBodyMotionCoeffs", dmd)
    patch_name = str(co.get("patch", co.get("patches", "body")))
    body_idx = [i for i, p in enumerate(mesh.patches)
                if p.name == patch_name][0]
    com = tuple(float(x) for x in np.asarray(
        co.get("centreOfMass", [0, 0, 0]), float).reshape(-1)[-3:])
    moi = np.asarray(co.get("momentOfInertia", [1, 1, 1]),
                     float).reshape(-1)[-3:]
    springs = []
    restr = co.get("restraints", FoamDict())
    for rname, rd in (restr.items() if hasattr(restr, "items")
                      else []):
        if not hasattr(rd, "get"):
            continue
        if str(rd.get("sixDoFRigidBodyMotionRestraint",
                      rd.get("type", ""))) == "linearSpring":
            anchor = tuple(float(x) for x in np.asarray(
                rd.get("anchor", com), float).reshape(-1)[-3:])
            attach = tuple(float(x) for x in np.asarray(
                rd.get("refAttachmentPt", [0, 0, 0]),
                float).reshape(-1)[-3:])
            springs.append((anchor, attach,
                            _dim_scalar_of(rd, "stiffness", 0.0),
                            _dim_scalar_of(rd, "damping", 0.0),
                            _dim_scalar_of(rd, "restLength", 0.0)))
    bcfg = sixdof.RigidBodyConfig(
        mass=_dim_scalar_of(co, "mass", 1.0),
        I_body=tuple(moi),
        g=_read_gravity(case),
        springs=tuple(springs))
    cfg = fl_mod.FloatingConfig(
        nu=nu, body=bcfg, body_patch=body_idx, x0=com,
        r_inner=_dim_scalar_of(co, "innerDistance", 0.1),
        r_outer=_dim_scalar_of(co, "outerDistance", 0.3),
        rho_ref=_dim_scalar_of(co, "rhoInf", 1000.0),
        p_controls=case.solver_controls("p"))
    U = case.read_field("U")
    p = case.read_field("p")
    state = fl_mod.initial_state(case.poly_mesh, mesh, U, p, cfg)
    step = fl_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: pimpleDyMFoam + sixDoFRigidBodyMotion "
             f"(patch {patch_name})\n")
    for t in case.time.loop():
        state, diag = step(state, jnp.asarray(t.current_dt,
                                              mesh.v.dtype))
        bx = np.asarray(diag["body_x"])
        log.info(f"Time = {t.name}\nCentre of mass: ({bx[0]:.6g} "
                 f"{bx[1]:.6g} {bx[2]:.6g})\n")
        if t.write_time():
            case.write_fields([state["U"], state["p"]])
        if max_steps is not None and t.index >= max_steps:
            break
    case.write_fields([state["U"], state["p"]])
    case.final_state = {"state": state, "diag": diag}
    log.info("End\n")


def _pimple_attach_detach(case, dmd, max_steps: Optional[int]) -> None:
    """pimpleDyMFoam with an attachDetach topology modifier
    (reference: src/dynamicMesh/attachDetach/ driven by
    topoChangerFvMesh — the valve/gate pattern: a set of coincident
    internal faces detaches into a wall pair at detachTime and
    re-attaches at attachTime).

    Structure (same re-trace-on-topo-event strategy as layering/
    AMR, mesh/topo.py): the two topologies share IDENTICAL cells (only
    the face list differs), so the field remap across an event is the
    identity — exactly conservative; the flux is re-derived from U on
    the new face set (zero through the detached pair by construction)
    and the step re-traces."""
    import numpy as _np

    from ..mesh import to_device
    from ..mesh import topo as topo_mod

    coeffs = dmd.get("attachDetachCoeffs", FoamDict())
    axis = {"x": 0, "y": 1, "z": 2}[str(coeffs.get("axis", "x"))]
    plane_pos = float(coeffs.get("position", 0.5))
    detach_t = float(coeffs.get("detachTime", 0.0))
    attach_t = float(coeffs.get("attachTime", 1e30))

    pm0 = case.poly_mesh
    topo = topo_mod.analyze(pm0, axis)
    planes = topo.planes
    s = int(_np.argmin(_np.abs(planes[1:-1] - plane_pos))) + 1
    log.info(f"attachDetach: plane {s} at {planes[s]:.6g} along "
             f"{'xyz'[axis]}, detach at t={detach_t:.6g}, "
             f"attach at t={attach_t:.6g}\n")

    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    cdict = case.pimple_controls("PIMPLE")

    def build(detached):
        pm = topo_mod.build(topo, planes,
                            detach_planes=(s,) if detached else ())
        mesh = to_device(pm)
        case._poly, case._mesh = pm, mesh
        cfg = piso_mod.PisoConfig(
            nu=nu, n_correctors=int(cdict.get("nCorrectors", 2)),
            n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
            corrected=case.laplacian_corrected(),
            div_scheme=case.div_scheme("div(phi,U)"),
            p_ref_cell=int(cdict.get("pRefCell", 0)),
            p_ref_value=float(cdict.get("pRefValue", 0.0)),
            p_controls=case.solver_controls("p"),
            u_controls=case.solver_controls("U"))
        return pm, mesh, cfg

    # initial fields in slab-major layered order (cell ids are then
    # invariant across attach/detach events)
    U0 = topo_mod.reorder_to_layers(topo,
                                    _np.asarray(case.read_field("U").data))
    p0 = topo_mod.reorder_to_layers(topo,
                                    _np.asarray(case.read_field("p").data))

    t = case.time
    detached = t.start_time >= detach_t and t.start_time < attach_t
    pm, mesh, cfg = build(detached)
    U = _field_on_mesh(case, "U", mesh, jnp.asarray(U0, mesh.v.dtype))
    p = _field_on_mesh(case, "p", mesh, jnp.asarray(p0, mesh.v.dtype))
    state = piso_mod.initial_state(mesh, U, p)
    step = piso_mod.make_step(mesh, cfg)

    log.info(f"Starting loop: pimpleDyMFoam (attachDetach), "
             f"{mesh.n_cells} cells, "
             f"{'DETACHED' if detached else 'attached'}\n")
    cumulative = 0.0
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)
    diag = None

    def write(state):
        case.write_fields([state["U"], state["p"]])

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        t_next = t.start_time + (t.index + 1) * t.delta_t
        want_detached = t_next >= detach_t and t_next < attach_t
        if want_detached != detached:
            # topology event: identical cells, identity field remap
            log.info(f"attachDetach event at t={t_next:.6g}: "
                     f"{'DETACH' if want_detached else 'ATTACH'}\n")
            detached = want_detached
            Ud, pd = state["U"].data, state["p"].data
            pm, mesh, cfg = build(detached)
            U = _field_on_mesh(case, "U", mesh,
                               jnp.asarray(_np.asarray(Ud),
                                           mesh.v.dtype))
            p = _field_on_mesh(case, "p", mesh,
                               jnp.asarray(_np.asarray(pd),
                                           mesh.v.dtype))
            state = piso_mod.initial_state(mesh, U, p)
            step = piso_mod.make_step(mesh, cfg)
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def pimple_dym_foam(case, max_steps: Optional[int] = None) -> None:
    """pimpleDyMFoam: transient incompressible flow on a moving mesh
    (reference: applications/solvers/incompressible/pimpleFoam/
    pimpleDyMFoam/). Motion from constant/dynamicMeshDict
    solidBodyMotionFvMesh functions (linear / oscillatingLinear /
    rotating). Laminar (documented deviation: no turbulence coupling on
    the moving-mesh path yet)."""
    from ..mesh import moving
    from . import pimpledym as dym_mod

    mesh = case.mesh
    dmd = case.properties("dynamicMeshDict")
    solver_nm = str(dmd.get("motionSolverLibs", ""))
    msd = dmd.get("motionSolver", dmd.get("solver", ""))
    if (str(msd) == "sixDoFRigidBodyMotion"
            or "sixDoFRigidBodyMotion" in solver_nm):
        return _pimple_dym_sixdof(case, dmd, max_steps)
    if (str(dmd.get("topoChanger", "")) == "attachDetach"
            or "attachDetachCoeffs" in dmd):
        return _pimple_attach_detach(case, dmd, max_steps)
    coeffs = dmd.get("solidBodyMotionFvMeshCoeffs", dmd)
    fn = str(coeffs.get("solidBodyMotionFunction", "linearMotion"))
    c = coeffs.get(fn + "Coeffs", FoamDict())

    def vec(key, default=(0.0, 0.0, 0.0)):
        v = c.get(key, default)
        return tuple(float(q) for q in v)

    def scal(key, default=1.0):
        v = c.get(key, default)
        if isinstance(v, (list, tuple)):
            v = v[-1]
        return float(v)

    if fn == "oscillatingLinearMotion":
        pts_fn, umesh_fn = moving.oscillating_linear_motion(
            vec("amplitude"), scal("omega"))
    elif fn == "rotatingMotion":
        pts_fn, umesh_fn = moving.rotating_motion(
            vec("origin"), vec("axis", (0.0, 0.0, 1.0)), scal("omega"))
    elif fn == "linearMotion":
        pts_fn, umesh_fn = moving.linear_motion(vec("velocity"))
    else:
        raise ValueError(f"unsupported solidBodyMotionFunction {fn!r}")

    _, nu = dimensioned_scalar(case.transport_properties()["nu"])
    cdict = case.pimple_controls("PIMPLE")
    cfg = dym_mod.DyMConfig(
        nu=nu, pts_fn=pts_fn, umesh_fn=umesh_fn,
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        p_ref_cell=int(cdict.get("pRefCell", 0)),
        p_ref_value=float(cdict.get("pRefValue", 0.0)),
        p_controls=case.solver_controls("p"),
        u_controls=case.solver_controls("U"))
    U = case.read_field("U")
    p = case.read_field("p")
    state = dym_mod.initial_state(case.poly_mesh, mesh, U, p, umesh_fn)
    step = dym_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: pimpleDyMFoam ({fn}), "
             f"{mesh.n_cells} cells\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)

    def write(state):
        case.write_fields([state["U"], state["p"]])

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def reacting_foam(case, max_steps: Optional[int] = None) -> None:
    """reactingFoam: compressible reacting flow with finite-rate
    laminar combustion (reference: applications/solvers/combustion/
    reactingFoam/). Mechanism read from constant/reactions
    (foamChemistry format) + per-species thermo from
    constant/thermo.compressibleGas; species fields Yi from 0/
    (Ydefault fallback). With per-species janaf tables present the
    solver runs in reactingMixture mode (reference:
    hePsiThermo<reactingMixture>): per-cell R(Y) and Cp(Y,T) feed the
    flow EOS; transport (mu) stays the dominant-species Sutherland."""
    import dataclasses as _dc

    from ..bc import patchfields as pfm
    from ..core.fields import VolField
    from ..models import chemistry as chem_mod, thermo as thermo_mod
    from . import reacting as reacting_mod
    from . import rhopimple as rp_mod

    mesh = case.mesh
    rx = case.properties("reactions")
    try:
        thd = case.properties("thermo.compressibleGas")
    except Exception:
        thd = None
    chem, W = chem_mod.from_foam_files(rx, thd)
    species = list(chem.species)

    flds = []
    for s in species:
        try:
            flds.append(case.read_field(s))
        except Exception:
            flds.append(case.read_field("Ydefault"))
    Ydata = jnp.stack([f.data for f in flds], axis=1)
    ymean = np.asarray(jnp.mean(Ydata, axis=0))

    bcs = []
    for ip, p in enumerate(mesh.patches):
        pbcs = [f.bcs[ip] for f in flds]
        kinds = [b.kind for b in pbcs]
        if kinds[0] == "empty":
            bcs.append(pfm.PatchField(kind="empty", vfrac=0.0))
            continue
        kind = kinds[0] if len(set(kinds)) == 1 else "mixed"

        def col(vals):
            return jnp.stack(
                [jnp.broadcast_to(jnp.asarray(v, mesh.v.dtype),
                                  (p.size,)) for v in vals], axis=1)

        # vfrac stays per-face [size] (the mixed machinery broadcasts it
        # over the species axis) — per-patch BC kinds must agree across
        # species, which every reference reactingFoam case satisfies
        bcs.append(pfm.PatchField(
            kind=kind,
            ref_value=col([b.ref_value for b in pbcs]),
            ref_grad=col([b.ref_grad for b in pbcs]),
            vfrac=jnp.broadcast_to(
                jnp.asarray(pbcs[0].vfrac, mesh.v.dtype), (p.size,)),
            opts=pbcs[0].opts))
    Y = VolField(data=Ydata, bcs=tuple(bcs), name="Y")

    dom = int(np.argmax(ymean))
    if thd is not None and species[dom] in thd:
        th = thermo_mod._janaf_from_mixture(thd[species[dom]])
        wsum = float(np.sum(ymean / np.maximum(W, 1e-3)))
        th = _dc.replace(th, R=8314.47 * wsum)  # mixture R = Ru sum(Y/W)
    else:
        th = thermo_mod.from_dict(
            case.properties("thermophysicalProperties"))

    model, tstate = _load_turbulence(case, max(th.mu, 1e-12))
    relax = _relaxation(case)
    cdict = case.pimple_controls("PIMPLE")
    try:
        pf_ctl = case.solver_controls("pFinal")
    except KeyError:
        pf_ctl = None
    flow = rp_mod.RhoPimpleConfig(
        thermo=th,
        n_outer=int(cdict.get("nOuterCorrectors", 1)),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        div_scheme_e=case.div_scheme("div(phi,e)"),
        grad_scheme=case.grad_scheme("grad(p)"),
        p_ref_value=float(cdict.get("pRefValue", 1e5)),
        p_controls=case.solver_controls("p"),
        p_controls_final=pf_ctl,
        u_controls=case.solver_controls("U"),
        e_controls=case.solver_controls("T") if _has_solver(case, "T")
        else None,
        turb=model,
        turb_relax=relax.get("k", 0.7),
    )
    y_ctl = case.solver_controls("Yi") if _has_solver(case, "Yi") else None
    # combustion closure from constant/combustionProperties (reference:
    # combustionModel::New; absent -> laminar direct integration)
    from ..models import combustion as comb_mod
    try:
        comb = comb_mod.from_dict(case.properties("combustionProperties"),
                                  chem)
    except Exception:
        comb = None
    # reactingMixture (hePsiThermo<reactingMixture>): per-species janaf
    # tables -> per-cell R(Y)/Cp(Y,T) honoured by the flow EOS
    cp_lo = cp_hi = t_common = None
    if thd is not None:
        lo_rows, hi_rows, tc_rows = [], [], []
        ok = True
        for sname in species:
            ent = thd.get(sname)
            if ent is None:
                ok = False
                break
            tdct = ent.get("thermodynamics", FoamDict())
            lo = [float(x) for x in tdct.get("lowCpCoeffs", [])]
            hi = [float(x) for x in tdct.get("highCpCoeffs", lo)]
            if len(lo) < 7:
                ok = False
                break
            lo_rows.append(lo[:7])
            hi_rows.append(hi[:7])
            tc_rows.append(float(tdct.get("Tcommon", 1000.0)))
        if ok:
            cp_lo = np.asarray(lo_rows)
            cp_hi = np.asarray(hi_rows)
            t_common = np.asarray(tc_rows)
    cfg = reacting_mod.ReactingConfig(flow=flow, chem=chem, W=W,
                                      y_controls=y_ctl, combustion=comb,
                                      cp_lo=cp_lo, cp_hi=cp_hi,
                                      t_common=t_common)
    U = case.read_field("U")
    p = case.read_field("p")
    T = case.read_field("T")
    state = reacting_mod.initial_state(mesh, U, p, T, Y, th)
    state = reacting_mod.seed_mixture_state(state, cfg)
    step = reacting_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: reactingFoam, {mesh.n_cells} cells, "
             f"{len(species)} species\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)
    from ..functionobjects import make_function_objects

    fol = make_function_objects(case)

    def write(state):
        fields = [state["U"], state["p"], state["T"]]
        Yf = state["Y"]
        for i, s in enumerate(species):
            fields.append(_dc.replace(flds[i], data=Yf.data[:, i], name=s))
        if "turb" in state and state["turb"]:
            fields += list(state["turb"].values())
        case.write_fields(fields)

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        log.info(log.solver_line("T", diag["T"]))
        fol.execute(t.name, state)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def xi_foam(case, max_steps: Optional[int] = None) -> None:
    """XiFoam: premixed combustion with the Weller b-Xi flame-wrinkling
    model on the compressible PIMPLE step (reference:
    applications/solvers/combustion/XiFoam/). b (regress variable) from
    0/b — ignition by an initial burnt kernel (setFields); Su/XiCoef
    from constant/combustionProperties. engineFoam runs the same
    physics on the crank-angle engineTime (reference:
    applications/solvers/combustion/engineFoam/)."""
    from ..models import thermo as thermo_mod
    from . import rhopimple as rp_mod, xifoam as xi_mod

    mesh = case.mesh
    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    model, tstate = _load_turbulence(case, max(th.mu, 1e-12))
    cdict = case.pimple_controls("PIMPLE")
    try:
        pf_ctl = case.solver_controls("pFinal")
    except KeyError:
        pf_ctl = None
    flow = rp_mod.RhoPimpleConfig(
        thermo=th,
        n_outer=int(cdict.get("nOuterCorrectors", 1)),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        div_scheme_e=case.div_scheme("div(phi,e)"),
        grad_scheme=case.grad_scheme("grad(p)"),
        p_ref_value=float(cdict.get("pRefValue", 1e5)),
        p_controls=case.solver_controls("p"),
        p_controls_final=pf_ctl,
        u_controls=case.solver_controls("U"),
        e_controls=case.solver_controls("T") if _has_solver(case, "T")
        else None,
        turb=model,
        turb_relax=_relaxation(case).get("k", 0.7),
        # PDRFoam (reference: applications/solvers/combustion/PDRFoam/)
        # runs the same b-Xi physics with sub-grid obstacle drag as a
        # porosity resistance from system/fvOptions (the reference's
        # PDRDragModel; its flame-area enhancement Ep/Xp fields are a
        # documented omission)
        fv_options=_load_fvoptions(case, th.mu / 1.2),
    )
    comb = case.properties("combustionProperties")
    su_e = comb.get("Su", 0.4)
    su = float(su_e[-1] if isinstance(su_e, (list, tuple)) else su_e)
    # laminarFlameSpeedCorrelation keyword selects a Gulders/
    # GuldersEGR/RaviPetersen Su(p,Tu) correlation (models/flamespeed)
    from ..models.flamespeed import make_flame_speed

    su_fn = make_flame_speed(comb, su_default=su)
    T = case.read_field("T")
    cfg = xi_mod.XiFoamConfig(
        flow=flow, Su0=su, su_fn=su_fn,
        SuMin=float(comb.get("SuMin", 0.01)),
        XiEqCoef=float(comb.get("XiEqCoef", comb.get("XiCoef", 0.62))),
        XiShapeCoef=float(comb.get("XiShapeCoef", 1.0)),
        q_comb=float(comb.get("qComb", 2.0e6)),
        Tu=float(comb.get("Tu", float(jnp.min(T.data)))),
        b_controls=case.solver_controls("b") if _has_solver(case, "b")
        else None)
    U = case.read_field("U")
    p = case.read_field("p")
    b = case.read_field("b")
    state = xi_mod.initial_state(mesh, U, p, T, b, th, turb_state=tstate)
    step = xi_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: XiFoam, {mesh.n_cells} cells, "
             f"Su={su} m/s\n")
    cumulative = 0.0
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    dt = jnp.asarray(t.delta_t, mesh.v.dtype)
    from ..functionobjects import make_function_objects

    fol = make_function_objects(case)

    def write(state):
        fields = [state["U"], state["p"], state["T"], state["b"],
                  state["b"].replace(data=state["Xi"], name="Xi")]
        if "turb" in state and state["turb"]:
            fields += list(state["turb"].values())
        case.write_fields(fields)

    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        state, diag = step(state, dt)
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        t.current_dt = float(dt)
        cumulative = _log_step(case, t, diag, cumulative)
        log.info(log.solver_line("b", diag["b"]))
        fol.execute(t.name, state)
        if t.write_time():
            write(state)
    write(state)
    log.info("End\n")
    case.final_state = state


def fire_foam(case, max_steps: Optional[int] = None) -> None:
    """fireFoam: buoyant diffusion-flame fire with
    infinitelyFastChemistry, optional P1 radiation, and optional
    pyrolysis / surface-film regions (reference:
    applications/solvers/combustion/fireFoam/). Species + mechanism
    from constant/reactions as reactingFoam; region models from
    constant/{pyrolysisProperties,surfaceFilmProperties} naming the
    coupled patches."""
    import dataclasses as _dc

    from ..bc import patchfields as pfm
    from ..core.fields import VolField
    from ..models import chemistry as chem_mod, combustion as comb_mod, \
        thermo as thermo_mod
    from . import buoyantrho as br_mod, firefoam as ff_mod

    mesh = case.mesh
    rx = case.properties("reactions")
    try:
        thd = case.properties("thermo.compressibleGas")
    except Exception:
        thd = None
    chem, W = chem_mod.from_foam_files(rx, thd)
    species = list(chem.species)
    flds = []
    for s in species:
        try:
            flds.append(case.read_field(s))
        except Exception:
            flds.append(case.read_field("Ydefault"))
    Ydata = jnp.stack([f.data for f in flds], axis=1)
    bcs = []
    for ip, p in enumerate(mesh.patches):
        pbcs = [f.bcs[ip] for f in flds]
        if pbcs[0].kind == "empty":
            bcs.append(pfm.PatchField(kind="empty", vfrac=0.0))
            continue
        kinds = [b.kind for b in pbcs]
        kind = kinds[0] if len(set(kinds)) == 1 else "mixed"

        def col(vals):
            return jnp.stack(
                [jnp.broadcast_to(jnp.asarray(v, mesh.v.dtype),
                                  (p.size,)) for v in vals], axis=1)

        bcs.append(pfm.PatchField(
            kind=kind,
            ref_value=col([b.ref_value for b in pbcs]),
            ref_grad=col([b.ref_grad for b in pbcs]),
            vfrac=jnp.broadcast_to(
                jnp.asarray(pbcs[0].vfrac, mesh.v.dtype), (p.size,)),
            opts=pbcs[0].opts))
    Y = VolField(data=Ydata, bcs=tuple(bcs), name="Y")

    th = thermo_mod.from_dict(case.properties("thermophysicalProperties"))
    model, tstate = _load_turbulence(case, max(th.mu, 1e-12))
    relax = _relaxation(case)
    cdict = case.pimple_controls("PIMPLE")
    try:
        pf_ctl = case.solver_controls("p_rghFinal")
    except KeyError:
        pf_ctl = None
    flow = br_mod.BuoyantRhoConfig(
        thermo=th, g=_read_gravity(case),
        n_outer=int(cdict.get("nOuterCorrectors", 1)),
        n_correctors=int(cdict.get("nCorrectors", 2)),
        n_non_orth=int(cdict.get("nNonOrthogonalCorrectors", 0)),
        corrected=case.laplacian_corrected(),
        div_scheme=case.div_scheme("div(phi,U)"),
        div_scheme_e=case.div_scheme("div(phi,e)"),
        grad_scheme=case.grad_scheme("grad(p_rgh)"),
        p_ref_value=float(cdict.get("pRefValue", 1e5)),
        p_controls=case.solver_controls("p_rgh"),
        p_controls_final=pf_ctl,
        u_controls=case.solver_controls("U"),
        e_controls=case.solver_controls("T") if _has_solver(case, "T")
        else None,
        turb=model, turb_relax=relax.get("k", 0.7))
    rad = _load_radiation(case)
    if rad is not None:
        flow = flow._replace(radiation=rad)
    try:
        comb = comb_mod.from_dict(case.properties("combustionProperties"),
                                  chem)
    except Exception:
        comb = comb_mod.Combustion(chem=chem,
                                   model="infinitelyFastChemistry")
    # optional regions
    pyro_mesh = pyro_cfg = film_mesh = film_cfg = None
    h_conv, T_ref_wall = 20.0, 300.0
    ppath = case.const_path("pyrolysisProperties")
    if os.path.exists(ppath):
        from ..regionmodels import PyrolysisConfig, build_film_mesh

        pd = parse_file(ppath)
        patches = [str(s) for s in pd.get("patches", [])]
        if patches:
            pyro_mesh = build_film_mesh(case.poly_mesh, patches)
            cc = pd.get("reactingOneDimCoeffs", FoamDict())
            h_conv = float(cc.get("h", h_conv))
            T_ref_wall = float(cc.get("T0", T_ref_wall))
            pyro_cfg = PyrolysisConfig(
                n_layers=int(cc.get("nLayers", 8)),
                thickness=float(cc.get("thickness", 0.01)),
                k_s=float(cc.get("k", 0.2)),
                rho_s0=float(cc.get("rho", 700.0)),
                rho_char=float(cc.get("rhoChar", 100.0)),
                cp_s=float(cc.get("Cp", 1500.0)),
                A=float(cc.get("A", 1e8)),
                Ta=float(cc.get("Ta", 15000.0)))
    fpath = case.const_path("surfaceFilmProperties")
    if os.path.exists(fpath):
        from ..regionmodels import FilmConfig, build_film_mesh

        fd = parse_file(fpath)
        patches = [str(s) for s in fd.get("patches", [])]
        if patches:
            film_mesh = build_film_mesh(case.poly_mesh, patches)
            cc = fd.get("thermoSingleLayerCoeffs", FoamDict())
            film_cfg = FilmConfig(
                thermo=True, g=_read_gravity(case),
                nu=float(cc.get("nu", 1e-6)),
                rho=float(cc.get("rho", 1000.0)),
                T_sat=float(cc.get("Tsat", 373.15)),
                evap_coeff=float(cc.get("evapCoeff", 1e-3)))
    fuel = str(rx.get("fuel", species[0]))
    cfg = ff_mod.FireConfig(
        flow=flow, chem=chem, W=W, combustion=comb,
        y_controls=case.solver_controls("Yi")
        if _has_solver(case, "Yi") else None,
        fuel_index=species.index(fuel) if fuel in species else 0,
        pyro_mesh=pyro_mesh, pyro_cfg=pyro_cfg,
        film_mesh=film_mesh, film_cfg=film_cfg,
        h_conv=h_conv, T_ref_wall=T_ref_wall)
    U = case.read_field("U")
    p_rgh = case.read_field("p_rgh")
    T = case.read_field("T")
    state = ff_mod.initial_state(mesh, U, p_rgh, T, Y, th, g=flow.g,
                                 turb_state=tstate, cfg=cfg)
    if flow.radiation is not None:
        from ..models import radiation as rad_mod

        state["G"] = rad_mod.make_G(mesh, flow.radiation, T.bcs)
    step = ff_mod.make_step(mesh, cfg)
    log.info(f"Starting loop: fireFoam, {mesh.n_cells} cells, "
             f"{len(species)} species\n")
    cumulative = 0.0
    from ..functionobjects import make_function_objects

    fol = make_function_objects(case)

    def write(state):
        fields = [state["U"], state["p_rgh"], state["T"]]
        Yf = state["Y"]
        for i, s in enumerate(species):
            fields.append(_dc.replace(flds[i], data=Yf.data[:, i],
                                      name=s))
        if "turb" in state and state["turb"]:
            fields += list(state["turb"].values())
        case.write_fields(fields)

    for t in case.time.loop():
        dt = jnp.asarray(t.current_dt, mesh.v.dtype)
        state, diag = step(state, dt)
        cumulative = _log_step(case, t, diag, cumulative)
        log.info(log.solver_line("T", diag["T"]))
        fol.execute(t.name, state)
        t.adjust_delta_t(float(diag["courant_max"]))
        if t.write_time():
            write(state)
        if max_steps is not None and t.index >= max_steps:
            break
    write(state)
    log.info("End\n")
    case.final_state = state


def rho_simplefoam(case, max_steps: Optional[int] = None):
    _rho_pimple_run(case, steady=True, transonic=False, max_steps=max_steps)


def rho_pimplefoam(case, max_steps: Optional[int] = None):
    _rho_pimple_run(case, steady=False, transonic=False, max_steps=max_steps)


def rho_simplecfoam(case, max_steps: Optional[int] = None):
    """rhoSimplecFoam (reference: applications/solvers/compressible/
    rhoSimpleFoam/rhoSimplecFoam/): SIMPLEC-consistent rhoSimpleFoam."""
    _rho_pimple_run(case, steady=True, transonic=False,
                    max_steps=max_steps, consistent=True)


def rho_pimplecfoam(case, max_steps: Optional[int] = None):
    """rhoPimplecFoam (reference: applications/solvers/compressible/
    rhoPimpleFoam/rhoPimplecFoam/): SIMPLEC-consistent rhoPimpleFoam."""
    _rho_pimple_run(case, steady=False, transonic=False,
                    max_steps=max_steps, consistent=True)


def sonicfoam(case, max_steps: Optional[int] = None):
    _rho_pimple_run(case, steady=False, transonic=True, max_steps=max_steps)


case_mod.register_application("XiFoam", xi_foam)
case_mod.register_application("PDRFoam", xi_foam)
case_mod.register_application("fireFoam", fire_foam)
case_mod.register_application("rhoSimpleFoam", rho_simplefoam)
case_mod.register_application("rhoPimpleFoam", rho_pimplefoam)
case_mod.register_application("rhoSimplecFoam", rho_simplecfoam)
case_mod.register_application("rhoPimplecFoam", rho_pimplecfoam)
case_mod.register_application("sonicFoam", sonicfoam)
case_mod.register_application("solidDisplacementFoam",
                              solid_displacement_foam)
case_mod.register_application("solidEquilibriumDisplacementFoam",
                              solid_equilibrium_displacement_foam)
case_mod.register_application("buoyantSimpleFoam", buoyant_simplefoam)
case_mod.register_application("buoyantPimpleFoam", buoyant_pimplefoam)
case_mod.register_application("buoyantBoussinesqSimpleFoam",
                              buoyant_boussinesq_simplefoam)
case_mod.register_application("buoyantBoussinesqPimpleFoam",
                              buoyant_boussinesq_pimplefoam)
case_mod.register_application("icoFoam", icofoam)
case_mod.register_application("nonNewtonianIcoFoam", non_newtonian_icofoam)
case_mod.register_application("interFoam", interfoam_app)
# porousInterFoam / MRFInterFoam (reference: interFoam variants) — the
# porous/MRF zones load from system/fvOptions + constant/MRFZones via
# the same InterConfig hooks
case_mod.register_application("porousInterFoam", interfoam_app)
case_mod.register_application("MRFInterFoam", interfoam_app)
case_mod.register_application(
    "LTSInterFoam",
    lambda case, max_steps=None: interfoam_app(case, max_steps,
                                               lts=True))
case_mod.register_application(
    "interDyMFoam",
    lambda case, max_steps=None: interfoam_app(case, max_steps,
                                               dym=True))
case_mod.register_application("rhoCentralFoam", rhocentralfoam_app)
case_mod.register_application("rhoCentralDyMFoam",
                              rhocentral_dym_foam)
case_mod.register_application("pisoFoam", pisofoam)
case_mod.register_application("pimpleFoam", pimplefoam)
case_mod.register_application("simpleFoam", simplefoam)
# 2.2.x ships MRF* as separate applications; here the MRF zones are
# picked up from constant/MRFZones by the base drivers, so these are
# aliases (reference: applications/solvers/incompressible/MRFSimpleFoam/)
case_mod.register_application("MRFSimpleFoam", simplefoam)
case_mod.register_application("MRFPimpleFoam", pimplefoam)
# single rotating frame: whole-domain MRF from constant/SRFProperties
# (reference: incompressible/{SRFSimpleFoam,SRFPimpleFoam})
case_mod.register_application("SRFSimpleFoam", simplefoam)
case_mod.register_application("SRFPimpleFoam", pimplefoam)
# porous zones are picked up from constant/porousZones by
# _load_fvoptions (reference: applications/solvers/incompressible/
# porousSimpleFoam/ reads porousZones into the momentum equation)
case_mod.register_application("porousSimpleFoam", simplefoam)
# compressible porous/MRF family: the rho drivers read constant/
# {porousZones,MRFZones} too (reference: applications/solvers/
# compressible/rhoPorousMRFSimpleFoam etc.)
case_mod.register_application("rhoPorousSimpleFoam", rho_simplefoam)
case_mod.register_application("rhoPorousMRFSimpleFoam", rho_simplefoam)
case_mod.register_application("rhoPorousMRFPimpleFoam", rho_pimplefoam)
case_mod.register_application("rhoPorousMRFLTSPimpleFoam",
                              rho_pimplefoam)
# channelFoam = pimpleFoam + meanVelocityForce driving the prescribed
# Ubar (reference: incompressible/channelFoam/ gradP adjustment);
# windSimpleFoam = simpleFoam + actuationDiskSource fvOptions
# (reference: incompressible/windSimpleFoam/)
case_mod.register_application("channelFoam", pimplefoam)
case_mod.register_application("windSimpleFoam", simplefoam)
case_mod.register_application("electrostaticFoam", electrostatic_foam)
case_mod.register_application("magneticFoam", magnetic_foam)
case_mod.register_application("financialFoam", financial_foam)
case_mod.register_application("mhdFoam", mhd_foam)
case_mod.register_application("cavitatingFoam", cavitating_foam)
case_mod.register_application(
    "sonicLiquidFoam",
    lambda case, max_steps=None: cavitating_foam(case, max_steps,
                                                 sonic_liquid=True))
case_mod.register_application("chemFoam", chem_foam)
case_mod.register_application("boundaryFoam", boundary_foam)
case_mod.register_application("shallowWaterFoam", shallow_water_foam)
case_mod.register_application("dnsFoam", dns_foam)


def _cht(case, max_steps=None):
    from .chtmultiregion import cht_multi_region_foam

    cht_multi_region_foam(case, max_steps=max_steps)


case_mod.register_application("chtMultiRegionFoam", _cht)
case_mod.register_application("chtMultiRegionSimpleFoam", _cht)
case_mod.register_application("icoUncoupledKinematicParcelFoam",
                              ico_uncoupled_kinematic_parcel_foam)
case_mod.register_application("uncoupledKinematicParcelFoam",
                              ico_uncoupled_kinematic_parcel_foam)
case_mod.register_application("pimpleDyMFoam", pimple_dym_foam)
case_mod.register_application("compressibleInterFoam",
                              compressible_inter_foam)
case_mod.register_application("twoPhaseEulerFoam", two_phase_euler_foam)
case_mod.register_application("multiphaseEulerFoam", multiphase_euler_foam)
case_mod.register_application("twoLiquidMixingFoam",
                              two_liquid_mixing_foam)
case_mod.register_application("MRFMultiphaseInterFoam",
                              multiphase_inter_foam)
case_mod.register_application("multiphaseInterFoam",
                              multiphase_inter_foam)
case_mod.register_application("bubbleFoam", two_phase_euler_foam)
case_mod.register_application("interPhaseChangeFoam",
                              inter_phase_change_foam)
case_mod.register_application("interMixingFoam", inter_mixing_foam)
case_mod.register_application("settlingFoam", settling_foam)
case_mod.register_application("reactingParcelFoam",
                              reacting_parcel_foam)
case_mod.register_application("LTSReactingParcelFoam",
                              lts_reacting_parcel_foam)
case_mod.register_application("porousExplicitSourceReactingParcelFoam",
                              porous_reacting_parcel_foam)
case_mod.register_application("coalChemistryFoam", coal_chemistry_foam)
case_mod.register_application("sprayFoam", spray_foam)
case_mod.register_application("reactingParcelFilmFoam",
                              reacting_parcel_film_foam)
case_mod.register_application("adjointShapeOptimizationFoam",
                              adjoint_shape_optimization_foam)
case_mod.register_application("potentialFreeSurfaceFoam",
                              potential_free_surface_foam)
case_mod.register_application("engineFoam", engine_foam)
case_mod.register_application("sprayEngineFoam", spray_engine_foam)
case_mod.register_application("sonicDyMFoam", sonic_dym_foam)
case_mod.register_application("coldEngineFoam", cold_engine_foam)
case_mod.register_application("dsmcFoam", dsmc_foam)
case_mod.register_application("mdFoam", md_foam)
case_mod.register_application("mdEquilibrationFoam",
                              md_equilibration_foam)
case_mod.register_application("reactingFoam", reacting_foam)
case_mod.register_application("rhoReactingFoam", reacting_foam)
case_mod.register_application("scalarTransportFoam", scalar_transport_foam)
case_mod.register_application("laplacianFoam", laplacian_foam)
case_mod.register_application("potentialFoam", potential_foam)
