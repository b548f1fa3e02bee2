"""Lagrangian-averaged dynamic Smagorinsky (Meneveau-Lund-Cabot).

Reference: src/turbulenceModels/incompressible/LES/dynLagrangian/
dynLagrangian.C — the dynamic coefficient is averaged along fluid
pathlines by transporting the two Germano correlations flm ~ <L:M> and
fmm ~ <M:M> with a relaxation time T = theta delta (flm fmm)^{-1/8}:

    ddt(flm) + div(phi, flm) == invT (L:M - flm)
    ddt(fmm) + div(phi, fmm) == invT (M:M - fmm)
    cD = flm / fmm,   nuSgs = cD delta^2 |S|

Design notes: the same simple_filter / Germano tensors as the
homogeneous dynamic model (les2.py); the two transport equations are
solved implicitly with the shared multi-RHS Krylov path — both share
one upwind convection matrix (identical operator, two right-hand
sides).
"""

from __future__ import annotations

import jax.numpy as jnp

from ...core.fields import VolField
from .base import TurbulenceModel, register
from .les import Smagorinsky
from .les2 import (K_MIN, _dev, _filter_tensor, _sym_grad,
                   simple_filter)


class DynLagrangian(Smagorinsky):
    name = "dynLagrangian"
    field_names = ("nut", "flm", "fmm")

    theta = 1.5
    flm0 = 0.0
    fmm0 = 1e-7

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.theta = float(c.get("theta", self.theta))

    def init_state(self, mesh, case=None):
        st = super().init_state(mesh, case)
        from ...core.fields import vol_scalar

        from ...core.dimensions import DimensionSet

        d4t4 = DimensionSet.of(0, 4, -4)
        if case is not None:
            for nm, v0 in (("flm", self.flm0), ("fmm", self.fmm0)):
                try:
                    st[nm] = case.read_field(nm)
                    continue
                except Exception:
                    pass
                st[nm] = vol_scalar(mesh, v0, name=nm, dims=d4t4)
        else:
            st["flm"] = vol_scalar(mesh, self.flm0, name="flm",
                                   dims=d4t4)
            st["fmm"] = vol_scalar(mesh, self.fmm0, name="fmm",
                                   dims=d4t4)
        return st

    def correct(self, mesh, tstate, U, phi, dt, steady=False,
                relax=1.0, controls=None, phi_slot=None):
        from ...core.dimensions import DimensionSet
        from ...ops import fvm
        from .. import turbulence  # noqa: F401 (registry side effect)
        from ...solvers import linear

        nut_f: VolField = tstate["nut"]
        flm_f: VolField = tstate["flm"]
        fmm_f: VolField = tstate["fmm"]
        rdt = 1.0 / dt
        delta = jnp.cbrt(mesh.v)
        delta2 = delta ** 2

        S = _sym_grad(mesh, U)
        magS = jnp.sqrt(2.0 * jnp.sum(S * S, axis=(1, 2)))
        Uf = simple_filter(mesh, U.data)
        UU = jnp.einsum("ci,cj->cij", U.data, U.data)
        L = _dev(_filter_tensor(mesh, UU)
                 - jnp.einsum("ci,cj->cij", Uf, Uf))
        Sf = _filter_tensor(mesh, S)
        magSf = jnp.sqrt(2.0 * jnp.sum(Sf * Sf, axis=(1, 2)))
        M = delta2[:, None, None] * (
            4.0 * magSf[:, None, None] * Sf
            - _filter_tensor(mesh, magS[:, None, None] * S))
        LM = jnp.sum(L * M, axis=(1, 2))
        MM = jnp.sum(M * M, axis=(1, 2))

        flm = jnp.maximum(flm_f.data, 0.0)
        fmm = jnp.maximum(fmm_f.data, self.fmm0)
        invT = (flm * fmm) ** 0.125 / (self.theta * delta)

        ctl = controls or {"solver": "PBiCGStab", "tolerance": 1e-8,
                           "relTol": 0.01, "maxIter": 200}
        diag = {}
        from .ras import _div_weights

        new_vals = {}
        for nm, f, rhs in (("flm", flm_f, LM), ("fmm", fmm_f, MM)):
            w = _div_weights(mesh, phi, f)
            eqn = (fvm.ddt(mesh, f, f.data, rdt)
                   + fvm.div(mesh, phi, f, weights=w)
                   + fvm.Sp(mesh, invT, f))
            eqn = eqn.add_source(invT * rhs, mesh)
            data, perf = linear.solve(mesh, eqn, f.data, ctl)
            new_vals[nm] = data
            diag[nm] = perf
        flm_n = jnp.maximum(new_vals["flm"], 0.0)
        fmm_n = jnp.maximum(new_vals["fmm"], self.fmm0)

        cD = jnp.clip(flm_n / fmm_n, 0.0, 0.5)
        nut_new = cD * delta2 * magS
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(nut=new_nut, flm=flm_f.with_data(flm_n),
                   fmm=fmm_f.with_data(fmm_n))
        return new, diag


register("dynLagrangian", DynLagrangian)
