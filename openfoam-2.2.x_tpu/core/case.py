"""Case: load an OpenFOAM case directory and run its application.

The host-side orchestration layer replacing the reference's per-solver
main() + objectRegistry (reference: applications/solvers/*/: setRootCase,
createTime, createMesh, createFields). A Case owns:

- system/: controlDict (Time), fvSchemes, fvSolution
- constant/: polyMesh (read once, moved to device), *Properties dicts
- <time>/: fields (read at start, written per write-control)

`run_case(dir)` dispatches on the controlDict `application` keyword to
the registered solver applications — the equivalent of the reference's
one-binary-per-solver layout with run-time selection.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from . import runtime
from .dictionary import FoamDict, parse_file
from ..io import fields as field_io
from ..io import polymesh as mesh_io
from ..mesh import to_device


class Case:
    def __init__(self, case_dir: str, region: str = ""):
        """region: multi-region cases (chtMultiRegionFoam) keep each
        region's mesh/fields/dicts under constant/<region>/,
        system/<region>/ and <time>/<region>/ (reference:
        regionProperties + fvMesh named-region constructors)."""
        self.dir = os.path.abspath(case_dir)
        self.region = region
        self.control_dict = parse_file(
            os.path.join(self.dir, "system", "controlDict"))
        self.fv_schemes = parse_file(self.sys_path("fvSchemes"))
        self.fv_solution = parse_file(self.sys_path("fvSolution"))
        self.time = runtime.Time(self.control_dict, self.dir)
        from ..utils import logging as _log

        _log.load_debug_switches(self.control_dict)
        self._mesh = None
        self._poly = None

    def sys_path(self, name: str) -> str:
        return os.path.join(self.dir, "system", self.region, name)

    def const_path(self, name: str) -> str:
        return os.path.join(self.dir, "constant", self.region, name)

    @property
    def application(self) -> str:
        return str(self.control_dict.get("application", "unknown"))

    # -- mesh -----------------------------------------------------------------
    @property
    def poly_mesh(self):
        if self._poly is None:
            self._poly = mesh_io.read(self.const_path("polyMesh"))
        return self._poly

    def _retain_jump_cyclics(self, pm):
        """Scan start-time fields for jumpCyclic-family BCs (fan /
        fixedJump) on cyclic patches; retype those pairs to cyclicAMI
        so they are RETAINED as coincident coupled boundary patches
        (identity AMI) instead of being internalised — the jump then
        enters through the fixedJump/fan patch fields (reference:
        createBaffles cyclic pairs + fvPatchFields/derived/fan)."""
        import dataclasses as _dc

        jump_names = set()
        tdir = os.path.join(self.dir, self.latest_time_name())
        if not os.path.isdir(tdir):
            return pm
        cyc = {p.name: p for p in pm.patches if p.type == "cyclic"}
        if not cyc:
            return pm
        for fn in sorted(os.listdir(tdir)):
            path = os.path.join(tdir, fn)
            if not os.path.isfile(path):
                continue
            try:
                bf = parse_file(path).get("boundaryField")
            except Exception:
                continue
            if not hasattr(bf, "items"):
                continue
            for pname, spec in bf.items():
                if not hasattr(spec, "get"):
                    continue
                if str(spec.get("type", "")) in ("fan", "fixedJump",
                                                 "fixedJumpAMI") \
                        and str(pname) in cyc:
                    p = cyc[str(pname)]
                    jump_names.add(p.name)
                    nbr = p.neighbour_patch
                    if nbr is None:
                        for q in cyc.values():
                            if q.neighbour_patch == p.name:
                                nbr = q.name
                    if nbr:
                        jump_names.add(nbr)
        if not jump_names:
            return pm
        patches = tuple(
            _dc.replace(p, type="cyclicAMI") if p.name in jump_names
            else p for p in pm.patches)
        return _dc.replace(pm, patches=patches)

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = to_device(self._retain_jump_cyclics(
                self.poly_mesh))
        return self._mesh

    def request_parallel(self, n_devices: Optional[int] = None) -> None:
        """`run -parallel`: shard the mesh over the local device mesh
        (GSPMD). The reference's decomposePar/processor<i> pipeline
        collapses to a NamedSharding of the global padded arrays
        (SURVEY.md §2b); solver state picks up the sharding through
        XLA propagation on the first step. numberOfSubdomains from
        system/decomposeParDict caps the device count when present."""
        import jax

        from ..parallel import gspmd

        n = n_devices
        dd = os.path.join(self.dir, "system", "decomposeParDict")
        if n is None and os.path.exists(dd):
            n = int(parse_file(dd).get("numberOfSubdomains", 0)) or None
        n = min(n or len(jax.devices()), len(jax.devices()))
        jmesh = gspmd.space_mesh(n)
        m = self.mesh
        self._mesh = gspmd.shard_pytree(m, jmesh, m.n_cells, m.n_faces)
        self.jmesh = jmesh
        gspmd.arm_halo(jmesh)
        from ..utils import logging as log

        log.info(f"Parallel: GSPMD sharding over {n} device(s)\n")

    # -- dictionaries -----------------------------------------------------------
    def transport_properties(self) -> FoamDict:
        return parse_file(self.const_path("transportProperties"))

    def latest_time_name(self) -> str:
        """Name of the latest time directory (falls back to start)."""
        t = self.time.latest_time()
        if t is None:
            t = self.time.start_time
        return runtime.time_name(t, self.time.time_precision)

    def properties(self, name: str) -> FoamDict:
        return parse_file(self.const_path(name))

    # -- fields ---------------------------------------------------------------------
    def read_field(self, name: str, time: Optional[str] = None):
        t = time or runtime.time_name(self.time.start_time)
        path = os.path.join(self.dir, t, self.region, name)
        if (not os.path.exists(path) and not os.path.exists(path + ".gz")
                and t == "0.0"):
            path = os.path.join(self.dir, "0", self.region, name)
        return field_io.read_field(path, self.mesh, name=name)

    def write_fields(self, fields, time_name: Optional[str] = None) -> None:
        t = time_name or self.time.name
        tdir = os.path.join(t, self.region) if self.region else t
        fmt = str(self.control_dict.get("writeFormat", "ascii"))
        compress = str(self.control_dict.get("writeCompression", "off")) in (
            "on", "yes", "true", "compressed")
        for f in fields:
            field_io.write_field(f, self.mesh, self.dir, tdir,
                                 fmt=fmt, compress=compress)
        self.time.register_write(t)

    # -- solver controls ---------------------------------------------------------
    def solver_controls(self, field_name: str) -> Dict:
        solvers = self.fv_solution.subdict("solvers")
        d = dict(solvers.match(field_name))
        d = {str(k): v for k, v in d.items()}
        # DIC/DILU/GaussSeidel are sequential: map to parallel
        # equivalents (documented deviation, SURVEY.md §7 decision 4)
        if str(d.get("preconditioner", "")) in ("DIC", "FDIC", "DILU"):
            d["preconditioner"] = "diagonal"
        if str(d.get("solver", "")) == "GAMG" and "_gamg" not in d:
            from ..solvers.linear.gamg import GAMG

            # honour the fvSolution smoother/sweep menu: Chebyshev is
            # the parallel stand-in for (sym)GaussSeidel
            # (documented deviation, SURVEY.md §7 decision 4);
            # FOAMTPU_GAMG_SMOOTHER overrides for experiments
            import os as _os

            sm = str(d.get("smoother", "Jacobi"))
            # GaussSeidel family -> damped Jacobi (the established
            # parallel stand-in; Chebyshev remains opt-in via the
            # explicit keyword — measured no faster and it perturbs
            # fixed-iteration-count trajectories)
            sm = {"GaussSeidel": "Jacobi", "symGaussSeidel": "Jacobi",
                  "DIC": "Jacobi",
                  "DICGaussSeidel": "Jacobi"}.get(sm, sm)
            sm = _os.environ.get("FOAMTPU_GAMG_SMOOTHER", sm)
            # sweep-count defaults 4+4 (not the reference's 0+2): the
            # stride-2 cycle leans on smoothing (see GAMG.__init__);
            # explicit fvSolution entries still win
            d["_gamg"] = GAMG(
                self.mesh, smoother=sm,
                n_pre=int(d.get("nPreSweeps", 4)),
                n_post=int(d.get("nPostSweeps", 4)))
        return d

    def pimple_controls(self, name: str = "PISO") -> FoamDict:
        for key in (name, "PISO", "PIMPLE", "SIMPLE"):
            if key in self.fv_solution:
                return self.fv_solution.subdict(key)
        return FoamDict()

    def div_scheme(self, keyword: str) -> str:
        div = self.fv_schemes.subdict("divSchemes")
        try:
            entry = div.match(keyword)
        except KeyError:
            entry = div["default"]
        toks = entry if isinstance(entry, list) else [entry]
        toks = [str(t) for t in toks]
        # "Gauss <scheme> [coeff...]"
        if toks and toks[0] == "Gauss":
            toks = toks[1:]
        return " ".join(toks) if toks else "linear"

    def ddt_scheme(self) -> str:
        """ddtSchemes/default keyword (reference: fv::ddtScheme::New).
        Returns e.g. 'Euler', 'backward', 'CrankNicolson 0.9',
        'steadyState'."""
        dd = self.fv_schemes.get("ddtSchemes")
        entry = dd.get("default", "Euler") if isinstance(dd, FoamDict) \
            else "Euler"
        toks = [str(t) for t in (entry if isinstance(entry, list) else [entry])]
        return " ".join(toks) if toks else "Euler"

    def grad_scheme(self, keyword: str = "default") -> str:
        """gradSchemes keyword lookup (reference: fv::gradScheme::New).
        Returns e.g. 'Gauss linear', 'leastSquares',
        'cellLimited Gauss linear 1'."""
        gs = self.fv_schemes.get("gradSchemes")
        if not isinstance(gs, FoamDict):
            return "Gauss linear"
        try:
            entry = gs.match(keyword)
        except KeyError:
            entry = gs.get("default", ["Gauss", "linear"])
        toks = [str(t) for t in (entry if isinstance(entry, list) else [entry])]
        return " ".join(toks) if toks else "Gauss linear"

    def laplacian_corrected(self) -> bool:
        lap = self.fv_schemes.subdict("laplacianSchemes")
        entry = lap.get("default", ["Gauss", "linear", "corrected"])
        toks = [str(t) for t in (entry if isinstance(entry, list) else [entry])]
        return "corrected" in toks or "limited" in " ".join(toks)

    def corr_limit(self) -> float:
        """snGrad correction limiter coefficient (reference:
        snGradSchemes/limitedSnGrad): 'corrected' -> 1.0 (unlimited),
        'limited <c>' / 'limited corrected <c>' -> c. Taken from the
        laplacianSchemes default (falling back to snGradSchemes)."""
        for dname in ("laplacianSchemes", "snGradSchemes"):
            d = self.fv_schemes.get(dname)
            if not isinstance(d, FoamDict):
                continue
            entry = d.get("default")
            if entry is None:
                continue
            toks = [str(t) for t in
                    (entry if isinstance(entry, list) else [entry])]
            if "limited" in toks:
                for t in reversed(toks):
                    try:
                        return float(t)
                    except ValueError:
                        continue
        return 1.0


# ---------------------------------------------------------------------------
# Application registry
# ---------------------------------------------------------------------------

_APPLICATIONS: Dict[str, Callable] = {}


def register_application(name: str, fn: Callable) -> None:
    _APPLICATIONS[name] = fn


def run_case(case_dir: str, max_steps: Optional[int] = None,
             parallel: bool = False) -> Case:
    case = Case(case_dir)
    app = case.application
    # lazy-register bundled solvers
    from ..solvers import apps as solver_apps  # noqa: F401

    if app not in _APPLICATIONS:
        raise ValueError(
            f"unknown application {app!r}; available: {sorted(_APPLICATIONS)}"
        )
    from ..utils import logging as log

    log.info(f"Device: {device_banner()}\n")
    if parallel:
        case.request_parallel()
    _APPLICATIONS[app](case, max_steps=max_steps)
    if parallel:
        log.info(f"Parallel: {sharding_report(case)}\n")
    return case


def device_banner() -> str:
    """'<platform> <device kind> x<count>' of the devices JAX runs on,
    printed in every solver log so a CPU fallback cannot go unseen."""
    import jax

    devs = jax.devices()
    return f"{devs[0].platform} {devs[0].device_kind} x{len(devs)}"


def sharding_report(case: Case) -> str:
    """Devices that actually hold the final U of a `-parallel` run, and
    the halo path its solves traced."""
    from ..parallel import gspmd

    state = getattr(case, "final_state", None) or {}
    U = state.get("U")
    data = getattr(U, "data", None)
    n = len(data.sharding.device_set) if data is not None else 0
    halo = "explicit" if gspmd.active_halo_mesh()[0] is not None \
        else "gspmd"
    return f"final U on {n} device(s), halo {halo}"
