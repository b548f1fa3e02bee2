"""Linear solver dispatch from fvSolution controls
(reference: fvMatrix::solve -> lduMatrix::solver::New,
src/finiteVolume/fvMatrices/fvMatrix/fvMatrixSolve.C).

Vector equations solve segregated, component by component, exactly as
the reference does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp

from . import krylov
from .krylov import SolverPerf

_SOLVERS = {
    "PCG": krylov.pcg,
    "PBiCG": krylov.bicgstab,
    "PBiCGStab": krylov.bicgstab,
    "smoothSolver": krylov.smooth_solver,
    "diagonal": krylov.diagonal_solver,
}


def register_solver(name, fn):
    _SOLVERS[name] = fn


def prep_pressure(mat, needs_ref: bool, ctl: Dict, ref_cell: int,
                  ref_value: float):
    """Apply the pressure reference for an all-Neumann system: cell
    pinning for point solvers, null-space deflation for GAMG (see
    gamg.py — pinning wrecks the MG convergence factor)."""
    ctl2 = dict(ctl)
    if needs_ref:
        if str(ctl.get("solver", "")) == "GAMG":
            ctl2["_singular"] = True
            ctl2["_ref"] = (ref_cell, ref_value)
        else:
            mat = mat.set_reference(ref_cell, ref_value)
    return mat, ctl2


def prepare_controls(mesh, mat, *controls_list):
    """For GAMG controls: build the coefficient-dependent prep (Galerkin
    hierarchy, stencils, coarsest dense inverse) ONCE and share it across
    the given control dicts — valid as long as the matrix COEFFICIENTS
    (diag/upper/lower/ic) are unchanged (the PISO/SIMPLE pressure matrix
    across correctors: only the source changes)."""
    out = []
    prep = None
    for ctl in controls_list:
        if ctl is None:
            out.append(None)
            continue
        ctl2 = dict(ctl)
        if str(ctl2.get("solver", "")) == "GAMG" and "_gamg" in ctl2:
            if prep is None:
                prep = ctl2["_gamg"].prepare(mesh, mat)
            ctl2["_prep"] = prep
        out.append(ctl2)
    return out[0] if len(out) == 1 else tuple(out)


def solve(mesh, mat, psi: Any, controls: Dict) -> Tuple[Any, SolverPerf]:
    """Solve mat*psi = source for the field data psi [nC,(3)];
    returns (new_psi, perf-of-first-component)."""
    from ...utils import logging as _log

    name = str(controls.get("solver", "PCG"))
    if _log.debug("lduMatrix"):
        _log.info(f"lduMatrix: solver={name} n={mesh.n_cells} "
                  f"symmetric={mat.symmetric} "
                  f"slot={'yes' if mat.soff is not None else 'no'} "
                  f"ami={'yes' if mat.ami_coef is not None else 'no'}\n")
    if name == "GAMG" and mat.ami_coef is not None:
        # the Galerkin coarsening does not (yet) carry the AMI
        # interface: dispatch to Krylov, which sees the full coupled
        # operator through the matvec
        name = "PBiCGStab"
        controls = dict(controls)
        controls.setdefault("preconditioner", "polynomial")
    if name == "GAMG":
        from .gamg import solve_gamg

        return solve_gamg(mesh, mat, psi, controls)
    fn = _SOLVERS[name]
    kw = dict(
        tol=float(controls.get("tolerance", 1e-6)),
        rel_tol=float(controls.get("relTol", 0.0)),
        max_iter=int(controls.get("maxIter", 1000)),
    )
    if name in ("PCG", "PBiCG", "PBiCGStab"):
        kw["precond"] = str(controls.get("preconditioner", "diagonal"))
    if name == "smoothSolver":
        kw["n_sweeps"] = int(controls.get("nSweeps", 1))

    # roll-based stencil SpMV (ops/stencil.py) — gather-free iterations.
    # Slot-assembled matrices (fvm fast path) skip even the one-time
    # coefficient gather.
    from ...ops import stencil as stencil_mod

    if mat.soff is not None:
        st = stencil_mod.StencilOp(
            tuple(mesh.st_deltas), mat.soff, mesh.fb_cells, mesh.fb_nbrs,
            mat.sfb)
    else:
        st = stencil_mod.mesh_stencil(mesh, mat.upper, mat.lower)
    row_off = st.off.sum(axis=1)
    if st.fb_cells.shape[0]:
        row_off = row_off.at[st.fb_cells].add(st.fb_coeffs)

    base_off = st.apply_off
    # FOAMTPU_HALO=explicit (armed by gspmd.shard_case): the fine-level
    # off-diagonal SpMV runs as a shard_map ppermute halo kernel instead
    # of GSPMD-partitioned rolls — the reference's processor-patch
    # send/recv seam, latency-optimal on a real interconnect. Only the pure
    # offset-stencil case qualifies (COO fallback/AMI keep GSPMD).
    from ...parallel import gspmd as _gspmd

    halo_jmesh, halo_axis = _gspmd.active_halo_mesh()
    if (halo_jmesh is not None and mat.soff is not None
            and st.fb_cells.shape[0] == 0 and st.deltas
            and mesh.n_cells % halo_jmesh.devices.size == 0
            and max(abs(int(d)) for d in st.deltas)
            <= mesh.n_cells // halo_jmesh.devices.size):
        from ...parallel import comm as _comm

        def base_off(x, _st=st):  # noqa: F811
            return _comm.halo_apply_off(halo_jmesh, _st.deltas, _st.off,
                                        x, axis=halo_axis)

    if mat.ami_coef is not None and getattr(mesh, "has_ami", False):
        # coupled-interface (cyclicAMI) off-diagonal term in every
        # matvec: +ami_coef[f] * sum_j w_fj psi[cell_j] on owner rows
        amc = mat.ami_coef if mat.ami_coef.ndim == 1 else \
            mat.ami_coef[:, 0]
        ce = amc[mesh.ami_entry_face] * mesh.ami_entry_w
        rows_ami = mesh.ami_entry_row
        cells_ami = mesh.ami_entry_cell

        def apply_off(x):
            acc = base_off(x)
            contrib = (ce[:, None] * x[cells_ami] if x.ndim == 2
                       else ce * x[cells_ami])
            return acc.at[rows_ami].add(contrib)

        row_off = row_off.at[rows_ami].add(ce)
    else:
        apply_off = base_off

    if name == "smoothSolver":
        if mat.symmetric:
            # Gershgorin bound on D^-1 A for the Chebyshev smoother
            row_abs = jnp.sum(jnp.abs(st.off), axis=1)
            if st.fb_cells.shape[0]:
                row_abs = row_abs.at[st.fb_cells].add(jnp.abs(st.fb_coeffs))
            d_for_lam = mat.diag_eff(mesh)
            if d_for_lam.ndim == 2:
                row_abs = row_abs[:, None]
            kw["lam_max"] = jnp.max(1.0 + row_abs / jnp.abs(d_for_lam))
        else:
            # sequential Gauss-Seidel has no parallel twin and plain Jacobi
            # cannot be Chebyshev-accelerated on a convection-bearing
            # (complex-spectrum) matrix — dispatch to Jacobi-
            # preconditioned BiCGStab, converging to the same
            # normFactor tolerances (documented deviation, SURVEY.md §7
            # decision 4).
            fn = krylov.bicgstab
            kw.pop("n_sweeps", None)
            kw["precond"] = "diagonal"

    if psi.ndim == 1:
        d = mat.diag_eff(mesh)
        b = mat.source_eff(mesh)

        def amul(x):
            return d * x + apply_off(x)

        return fn(amul, psi, b, d, row_sum=d + row_off,
                  amul_off=apply_off, **kw)

    # vector solve: all components as one multi-RHS system
    # (identical per-component math; 3x fewer sequential solves)
    d = mat.diag_eff(mesh)        # [nC,C] (per-component boundary coeffs)
    b = mat.source_eff(mesh)      # [nC,C]

    def amul_v(x):
        return d * x + apply_off(x)

    return fn(amul_v, psi, b, d, row_sum=d + row_off[:, None],
              amul_off=apply_off, **kw)
