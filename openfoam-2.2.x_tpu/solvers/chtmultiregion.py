"""chtMultiRegionFoam / chtMultiRegionSimpleFoam — conjugate heat
transfer across fluid and solid regions.

Rebuild of reference: applications/solvers/heatTransfer/
chtMultiRegionFoam/ ({fluid,solid}/*.H, regionProperties) with the
turbulentTemperatureCoupledBaffleMixed interface BC
(src/turbulenceModels/compressible/turbulenceModel/derivedFvPatchFields/
temperatureCoupledBase + ...CoupledBaffleMixed).

Redesign: each region is its own Case/mesh/jitted step; the
interface coupling is a per-outer-iteration HOST exchange of mixed-BC
data (refValue = neighbour face temperature, valueFraction from the
kappa*delta ratio — the reference's formula), with the face-to-face
map precomputed once by nearest-centre matching (the mappedWall
equivalent). Solid regions solve ddt(rho Cp T) = laplacian(kappa, T);
fluid regions reuse the compressible buoyant step
(solvers/buoyantrho.py).
"""

from __future__ import annotations

import dataclasses as _dc
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..bc import patchfields as pf
from ..core.dimensions import DimensionSet
from ..core.fields import VolField
from ..ops import fvm
from . import linear


class Interface(NamedTuple):
    """One coupled patch pair (regionA.patchA <-> regionB.patchB)."""
    region_a: str
    patch_a: str
    region_b: str
    patch_b: str
    # face maps: for each face of A's patch, the matched face index
    # WITHIN B's patch (and vice versa)
    a_to_b: np.ndarray
    b_to_a: np.ndarray


def match_interface(mesh_a, patch_a: str, mesh_b, patch_b: str,
                    region_a="A", region_b="B") -> Interface:
    """Nearest-centre face matching (mappedPatchBase equivalent)."""
    from scipy.spatial import cKDTree

    pa = mesh_a.patch(patch_a)
    pb = mesh_b.patch(patch_b)
    ca = np.asarray(mesh_a.cf)[pa.slice]
    cb = np.asarray(mesh_b.cf)[pb.slice]
    assert pa.size == pb.size, (pa.size, pb.size)
    ta = cKDTree(cb)
    d_ab, a_to_b = ta.query(ca)
    tb = cKDTree(ca)
    d_ba, b_to_a = tb.query(cb)
    assert d_ab.max() < 1e-6 + 0.5 * d_ab.mean() + 1e-9, \
        "interface faces do not conform"
    return Interface(region_a, patch_a, region_b, patch_b,
                     a_to_b.astype(np.int64), b_to_a.astype(np.int64))


def _patch_side_data(mesh, T: VolField, patch_name: str, kappa):
    """(T_cell, kappa*deltaCoeffs) on the patch faces — the coupled-BC
    exchange quantities (reference: temperatureCoupledBase::kappa and
    patchInternalField)."""
    p = mesh.patch(patch_name)
    cells = mesh.owner[p.slice]
    Tc = T.data[cells]
    kd = (kappa[cells] if hasattr(kappa, "shape") and np.ndim(kappa)
          else kappa) * mesh.delta_coeffs[p.slice]
    return Tc, kd


def update_coupled_bcs(mesh_a, Ta: VolField, kappa_a,
                       mesh_b, Tb: VolField, kappa_b,
                       iface: Interface) -> Tuple[VolField, VolField]:
    """Refresh both sides' mixed BCs (reference:
    turbulentTemperatureCoupledBaffleMixed::updateCoeffs):
      refValue      = neighbour patch-internal T
      refGrad       = 0
      valueFraction = kd_nbr / (kd_nbr + kd_own)
    """
    Tc_a, kd_a = _patch_side_data(mesh_a, Ta, iface.patch_a, kappa_a)
    Tc_b, kd_b = _patch_side_data(mesh_b, Tb, iface.patch_b, kappa_b)
    ab = jnp.asarray(iface.a_to_b)
    ba = jnp.asarray(iface.b_to_a)

    def set_bc(field, mesh, patch_name, t_nbr, kd_nbr, kd_own):
        ip = [i for i, p in enumerate(mesh.patches)
              if p.name == patch_name][0]
        bcs = list(field.bcs)
        frac = kd_nbr / jnp.maximum(kd_nbr + kd_own, 1e-30)
        bcs[ip] = bcs[ip].replace(ref_value=t_nbr, ref_grad=0.0,
                                  vfrac=frac)
        return _dc.replace(field, bcs=tuple(bcs))

    Ta = set_bc(Ta, mesh_a, iface.patch_a, Tc_b[ab], kd_b[ab], kd_a)
    Tb = set_bc(Tb, mesh_b, iface.patch_b, Tc_a[ba], kd_a[ba], kd_b)
    return Ta, Tb


# ---------------------------------------------------------------------------
# solid region (reference: chtMultiRegionFoam/solid/solveSolid.H)
# ---------------------------------------------------------------------------


class SolidConfig(NamedTuple):
    rho: float
    cp: float
    kappa: float
    steady: bool = False
    t_controls: Dict = None
    # optional solidThermo model (models/solidthermo.SolidThermo): when
    # set, solid_step runs the variable-property conservative form
    # rho(T) Cp(T) dT/dt = div(kappa(T) grad T) with face-interpolated
    # (or anisotropic n.K.n) conductivity instead of the constant path
    thermo: Any = None


def parse_regions(rp) -> Tuple[List[str], List[str]]:
    """constant/regionProperties `regions ( fluid (a b) solid (c) );`
    -> (fluids, solids)."""
    fluids: List[str] = []
    solids: List[str] = []
    items = rp.get("regions", [])
    items = list(items) if isinstance(items, list) else [items]
    current = None
    for it in items:
        s = str(it)
        if s in ("fluid", "solid"):
            current = s
        elif isinstance(it, (list, tuple)):
            names = [str(x) for x in it]
            (fluids if current == "fluid" else solids).extend(names)
        elif current is not None:
            (fluids if current == "fluid" else solids).append(s)
    return fluids, solids


def solid_step(mesh, T: VolField, T0, dt, cfg: SolidConfig):
    """rho Cp dT/dt = div(kappa grad T) (reference:
    chtMultiRegionFoam/solid/solveSolid.H). With cfg.thermo set the
    properties are evaluated per cell from the solidThermo model at the
    current T (explicit property lagging, as the reference's
    heSolidThermo correct() before the solve)."""
    ctl = cfg.t_controls or {"solver": "PCG",
                             "preconditioner": "polynomial",
                             "tolerance": 1e-9, "relTol": 0.01,
                             "maxIter": 2000}
    if cfg.thermo is not None:
        st = cfg.thermo
        kf = st.kappa_face(mesh, T.data).astype(mesh.v.dtype)
        lap = fvm.laplacian(
            mesh, kf, T, corrected=False,
            gamma_dims=DimensionSet.of(1, 1, -3, -1))   # W/m/K
        if cfg.steady:
            eqn = -lap
        else:
            rc = st.rho_cp(T.data).astype(mesh.v.dtype)  # J/m^3/K
            rdt = 1.0 / dt
            m = fvm.ddt(mesh, T, T0, rdt)
            m = m.replace_fields(
                diag=m.diag * rc, source=m.source * rc,
                dims=m.dims * DimensionSet.of(1, -1, -2, -1))
            eqn = m - lap
    else:
        lap = fvm.laplacian(
            mesh, jnp.asarray(cfg.kappa / (cfg.rho * cfg.cp),
                              mesh.v.dtype),
            T, corrected=False,
            gamma_dims=DimensionSet.of(0, 2, -1))
        if cfg.steady:
            eqn = -lap
        else:
            rdt = 1.0 / dt
            eqn = fvm.ddt(mesh, T, T0, rdt) - lap
    data, perf = linear.solve(mesh, eqn, T.data, ctl)
    return T.with_data(data), perf


# ---------------------------------------------------------------------------
# application driver
# ---------------------------------------------------------------------------


def cht_multi_region_foam(case, max_steps: Optional[int] = None) -> None:
    """chtMultiRegionFoam driver: per-region Cases/meshes, interface
    discovery by the reference's `<A>_to_<B>` patch naming, per-step
    region solves with coupled-BC exchange. Fluid regions run the
    compressible buoyant step (stagnant fluids reduce to conduction);
    solid regions the kappa Laplacian."""
    from ..core.case import Case
    from ..core.dictionary import dimensioned_scalar
    from ..models import thermo as thermo_mod
    from ..utils import logging as log
    from . import buoyantrho as br_mod
    from .apps import _read_gravity

    rp = case.properties("regionProperties")
    fluids, solids = parse_regions(rp)
    steady = "SIMPLE" in case.control_dict.get("application", "") or \
        str(case.control_dict.get("application")).endswith("SimpleFoam")

    regions: Dict[str, Dict[str, Any]] = {}
    for name in solids:
        rc = Case(case.dir, region=name)
        tp = rc.properties("thermophysicalProperties")
        from ..models import solidthermo as sth_mod
        st = sth_mod.from_dict(tp)
        T = rc.read_field("T")
        const_props = (st.transport == "constIso"
                       and st.thermo == "hConst")
        cfg = SolidConfig(
            rho=st.rho0, cp=float(st.cp_c[0]),
            kappa=float(st.kappa_c[0]), steady=steady,
            thermo=None if const_props else st)
        regions[name] = dict(kind="solid", case=rc, mesh=rc.mesh, T=T,
                             T0=T.data, cfg=cfg, sthermo=st,
                             kappa_cells=st.kappa(T.data).astype(
                                 rc.mesh.v.dtype))
    for name in fluids:
        rc = Case(case.dir, region=name)
        th = thermo_mod.from_dict(
            rc.properties("thermophysicalProperties"))
        cfg = br_mod.BuoyantRhoConfig(
            thermo=th, g=_read_gravity(rc), steady=steady,
            alpha_u=0.5 if steady else 1.0,
            alpha_p=0.7 if steady else 1.0,
            alpha_e=0.5 if steady else 1.0)
        U = rc.read_field("U")
        p_rgh = rc.read_field("p_rgh")
        T = rc.read_field("T")
        state = br_mod.initial_state(rc.mesh, U, p_rgh, T, th, g=cfg.g,
                                     steady=steady)
        kappa_f = th.mu / th.Pr * th.Cp   # laminar conductivity
        regions[name] = dict(kind="fluid", case=rc, mesh=rc.mesh,
                             state=state, cfg=cfg, thermo=th,
                             kappa_cells=jnp.full(rc.mesh.n_cells,
                                                  kappa_f,
                                                  rc.mesh.v.dtype))

    # interface discovery: patch "<A>_to_<B>" in region A pairs with
    # "<B>_to_<A>" in region B
    interfaces: List[Interface] = []
    names = list(regions)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            pa, pb = f"{a}_to_{b}", f"{b}_to_{a}"
            try:
                regions[a]["mesh"].patch(pa)
                regions[b]["mesh"].patch(pb)
            except KeyError:
                continue
            interfaces.append(match_interface(
                regions[a]["mesh"], pa, regions[b]["mesh"], pb, a, b))

    # jitted steps
    steps: Dict[str, Any] = {}
    for name, r in regions.items():
        if r["kind"] == "solid":
            mesh, cfg = r["mesh"], r["cfg"]
            steps[name] = jax.jit(
                lambda T, T0, dt, mesh=mesh, cfg=cfg:
                solid_step(mesh, T, T0, dt, cfg))
        else:
            mesh, cfg = r["mesh"], r["cfg"]
            steps[name] = jax.jit(
                lambda s, dt, mesh=mesh, cfg=cfg:
                br_mod.buoyantrho_step(mesh, s, dt, cfg))

    def get_T(name):
        r = regions[name]
        return r["T"] if r["kind"] == "solid" else r["state"]["T"]

    def set_T(name, T):
        r = regions[name]
        if r["kind"] == "solid":
            r["T"] = T
        else:
            r["state"]["T"] = T

    def exchange():
        for ifc in interfaces:
            ra, rb = regions[ifc.region_a], regions[ifc.region_b]
            Ta, Tb = update_coupled_bcs(
                ra["mesh"], get_T(ifc.region_a), ra["kappa_cells"],
                rb["mesh"], get_T(ifc.region_b), rb["kappa_cells"],
                ifc)
            set_T(ifc.region_a, Ta)
            set_T(ifc.region_b, Tb)

    def write_all():
        for name, r in regions.items():
            if r["kind"] == "solid":
                r["case"].write_fields([r["T"]],
                                       time_name=case.time.name)
            else:
                st = r["state"]
                r["case"].write_fields([st["U"], st["p_rgh"], st["T"]],
                                       time_name=case.time.name)

    log.info(f"Starting loop: chtMultiRegionFoam, regions "
             f"{sorted(regions)}, {len(interfaces)} interfaces\n")
    t = case.time
    max_iter = max(int(round((t.end_time - t.start_time) / t.delta_t)), 1)
    if max_steps is not None:
        max_iter = min(max_iter, max_steps)
    any_mesh = next(iter(regions.values()))["mesh"]
    dt = jnp.asarray(1.0 if steady else t.delta_t, any_mesh.v.dtype)
    while (t.index < max_iter and not t.stop_now
           and t.value < t.end_time - 1e-12):
        exchange()
        for name, r in regions.items():
            if r["kind"] == "solid":
                Tn, perf = steps[name](r["T"], r["T0"], dt)
                r["T"] = Tn.correct_boundary_conditions(r["mesh"])
                if not steady:
                    r["T0"] = r["T"].data
                st = r.get("sthermo")
                if st is not None and st.transport in ("exponential",
                                                      "polynomial"):
                    r["kappa_cells"] = st.kappa(r["T"].data).astype(
                        r["mesh"].v.dtype)
                last_perf = perf
            else:
                r["state"], diag = steps[name](r["state"], dt)
                last_perf = None
        t.index += 1
        t.value = t.start_time + t.index * t.delta_t
        log.info(f"Time = {t.name}\n")
        if last_perf is not None:
            log.info(log.solver_line("T", last_perf))
        if t.write_time():
            write_all()
    write_all()
    log.info("End\n")
    case.final_state = regions
