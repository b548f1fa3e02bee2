"""Differential-stress and localized-dynamic LES closures.

Reference: src/turbulenceModels/incompressible/LES/
  - locDynOneEqEddy/     (localized dynamic k-equation SGS)
  - dynMixedSmagorinsky/ (scale-similarity + dynamic Smagorinsky)
  - DeardorffDiffStress/ (SGS stress transport, Deardorff 1973
                          return-to-isotropy pressure-strain)
  - LRDDiffStress/       (SGS stress transport with the LRR
                          rapid pressure-strain term added)

Design notes: the stress-transport models ride the same
[nC,6] symmetric-tensor multi-RHS solve the RAS Reynolds-stress
models use (one matrix, six right-hand sides — ras2.LRR), with the
dissipation closed algebraically at the subgrid scale
(eps = Ce k^{3/2}/delta) instead of a transported epsilon. The
localized dynamic coefficient is a per-cell Germano contraction
smoothed by one application of the test filter (Piomelli & Liu 1995
localization) instead of the reference's cell-local bounding loop.
All constants are the published closure values.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp

from ...core.dimensions import dimViscosity
from ...core.fields import VolField
from ...ops import fvc, fvm
from .base import TurbulenceModel, bound_below, register
from .les import K_MIN, OneEqEddy, Smagorinsky
from .les2 import (DynOneEqEddy, HomogeneousDynSmagorinsky, _dev,
                   _filter_tensor, _sym_grad, _vavg, simple_filter)
from .ras2 import _div_symm_tensor, full_to_symm, symm_to_full

_I6 = (1.0, 0.0, 0.0, 1.0, 0.0, 1.0)


class LocDynOneEqEddy(DynOneEqEddy):
    """Localized dynamic one-equation eddy viscosity (reference:
    LES/locDynOneEqEddy/locDynOneEqEddy.C): Ck is computed per cell
    from the Germano identity instead of volume-averaged; the raw
    cellwise contraction is smoothed by one test-filter application
    and clipped to the realizable band (the reference bounds it with
    `bound(..)`; the clip is the jit-friendly equivalent)."""

    name = "locDynOneEqEddy"

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        k = jnp.maximum(tstate["k"].data, K_MIN)
        delta = jnp.cbrt(mesh.v)
        S = _sym_grad(mesh, U)
        Uf = simple_filter(mesh, U.data)
        UU = jnp.einsum("ci,cj->cij", U.data, U.data)
        L = _dev(_filter_tensor(mesh, UU)
                 - jnp.einsum("ci,cj->cij", Uf, Uf))
        KK = jnp.maximum(
            0.5 * (simple_filter(mesh, jnp.sum(U.data ** 2, axis=1))
                   - jnp.sum(Uf ** 2, axis=1)), 0.0)
        kf = jnp.maximum(simple_filter(mesh, k), K_MIN)
        Sf = _filter_tensor(mesh, S)
        M = delta[:, None, None] * (
            _filter_tensor(mesh, jnp.sqrt(k)[:, None, None] * S)
            - 2.0 * jnp.sqrt(kf + KK)[:, None, None] * Sf)
        # localized: per-cell contraction, filter-smoothed
        num = simple_filter(mesh, jnp.sum(L * M, axis=(1, 2)))
        den = simple_filter(mesh, jnp.sum(M * M, axis=(1, 2)))
        ck = -num / jnp.maximum(2.0 * den, 1e-30)
        ck = jnp.clip(ck, 0.0, 0.5)
        new, diag = OneEqEddy.correct(self, mesh, tstate, U, phi, dt,
                                      steady, relax, controls,
                                      phi_slot=phi_slot)
        k_new = jnp.maximum(new["k"].data, K_MIN)
        nut_new = ck * delta * jnp.sqrt(k_new)
        new["nut"] = new["nut"].with_data(
            nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        return new, diag


class DynMixedSmagorinsky(HomogeneousDynSmagorinsky):
    """Dynamic Smagorinsky + Bardina scale-similarity (reference:
    LES/mixedSmagorinsky + dynSmagorinsky combination,
    dynMixedSmagorinsky.C): the resolved scale-similarity stress is
    added explicitly on top of the dynamically-coefficient eddy
    viscosity."""

    name = "dynMixedSmagorinsky"

    def div_dev_reff(self, mesh, tstate, U: VolField):
        mat, src = super().div_dev_reff(mesh, tstate, U)
        Uf = simple_filter(mesh, U.data)
        UU = jnp.einsum("ci,cj->cij", U.data, U.data)
        B = _dev(_filter_tensor(mesh, UU)
                 - jnp.einsum("ci,cj->cij", Uf, Uf))
        divB = _div_symm_tensor(mesh, full_to_symm(B))
        return mat, src + divB


class DeardorffDiffStress(TurbulenceModel):
    """Deardorff SGS stress-transport model (reference:
    LES/DeardorffDiffStress/DeardorffDiffStress.C; Deardorff 1973):
    transports the full subgrid stress tensor B [nC,6],

        P = -twoSymm(B & grad U)
        eps = Ce k^{3/2}/delta          (algebraic, k = tr(B)/2)
        BEqn: ddt(B) + div(phi,B) - lap(DBEff,B)
              + Sp(Cm sqrt(k)/delta) B
              == P + (2/3)(Cm sqrt(k)/delta) k I - (2/3) eps I

    with the Rotta return-to-isotropy split implicit/explicit exactly
    as the reference does, DBEff = nu + Cs k^2/eps, and
    nuSgs = Ck delta sqrt(k) for the momentum coupling. The six
    components solve against one matrix (multi-RHS Krylov)."""

    name = "DeardorffDiffStress"
    field_names = ("B", "k", "nut")

    Ck = 0.094
    Cm = 4.13
    Ce = 1.048
    Cs = 0.25

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("Ck", "Cm", "Ce", "Cs"):
            setattr(self, key, float(c.get(
                key, c.get(key.lower(), getattr(self, key)))))

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def _rapid_term(self, P6, trP):
        """LRD adds -Clrr2*dev(P); Deardorff has no rapid term."""
        return None

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        from ...ops import slot as slot_mod
        from ...ops import surface as surface_mod
        from .ras import (_gamma_forms, _phi_slotform, _solve_transport,
                          _transport_ops)

        B_f: VolField = tstate["B"]
        k_fld: VolField = tstate["k"]
        nut_f: VolField = tstate["nut"]
        B6 = B_f.data
        delta = jnp.cbrt(mesh.v)
        rdt = 1.0 / dt
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        k = jnp.maximum(0.5 * (B6[:, 0] + B6[:, 3] + B6[:, 5]), K_MIN)
        sqrtk = jnp.sqrt(k)
        eps = self.Ce * sqrtk ** 3 / delta
        g = fvc.grad(mesh, U)
        Bfull = symm_to_full(B6)
        BgU = jnp.einsum("cik,ckj->cij", Bfull, g)
        P6 = full_to_symm(-(BgU + jnp.swapaxes(BgU, 1, 2)))
        trP = P6[:, 0] + P6[:, 3] + P6[:, 5]

        dB = self.nu + self.Cs * k * k / jnp.maximum(eps, 1e-20)
        dB_slot = slot_mod.interpolate(
            mesh, dB, bv=surface_mod.owner_to_b(mesh, dB))
        rotta = self.Cm * sqrtk / delta
        B_eqn = (
            fvm.ddt(mesh, B_f, B6, rdt)
            + _transport_ops(mesh, phi, phi_sl, B_f, self.div_scheme,
                             slot_mod.to_flat(mesh, dB_slot), dB_slot,
                             self.corrected, self.corr_limit)
            + fvm.Sp(mesh, rotta, B_f)
        )
        I6 = jnp.asarray(_I6, B6.dtype)[None, :]
        srcB = (P6
                + ((2.0 / 3.0) * rotta * k)[:, None] * I6
                - ((2.0 / 3.0) * eps)[:, None] * I6)
        rapid = self._rapid_term(P6, trP)
        if rapid is not None:
            srcB = srcB + rapid
        B_eqn = B_eqn.add_source(srcB, mesh)
        B_new, perf = _solve_transport(mesh, B_f, B_eqn, controls)
        diag_idx = jnp.asarray([0, 3, 5])
        B_new = B_new.at[:, diag_idx].set(
            jnp.maximum(B_new[:, diag_idx], K_MIN))
        k_new = jnp.maximum(
            0.5 * (B_new[:, 0] + B_new[:, 3] + B_new[:, 5]), K_MIN)
        nut_new = self.Ck * delta * jnp.sqrt(k_new)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(B=B_f.with_data(B_new), k=k_fld.with_data(k_new),
                   nut=new_nut)
        return new, {"B": perf}

    def div_dev_reff(self, mesh, tstate, U: VolField):
        """fvc::div(B) + fvc::laplacian(nuSgs, U) - fvm::laplacian(nuEff, U)
        (reference DeardorffDiffStress::divDevBeff)."""
        from ...ops import slot as slot_mod

        nu_slot = self.nu_eff_slot(mesh, tstate)
        mat = -fvm.laplacian(mesh, slot_mod.to_flat(mesh, nu_slot), U,
                             corrected=self.corrected,
                             gamma_dims=dimViscosity,
                             limit=self.corr_limit, gamma_slot=nu_slot)
        div_B = _div_symm_tensor(mesh, _dev6(tstate["B"].data))
        nut_face = self.nu_eff_face(mesh, tstate) - self.nu
        lap_U = fvc.laplacian(mesh, nut_face, U, corrected=False)
        return mat, div_B + lap_U


def _dev6(B6: Any) -> Any:
    tr = B6[:, 0] + B6[:, 3] + B6[:, 5]
    return B6 - (tr / 3.0)[:, None] * jnp.asarray(
        _I6, B6.dtype)[None, :]


class LRDDiffStress(DeardorffDiffStress):
    """LRR-type differential SGS stress model (reference:
    LES/LRDDiffStress/LRDDiffStress.C): Deardorff stress transport
    plus the LRR rapid pressure-strain term -C2 dev(P)."""

    name = "LRDDiffStress"
    C2 = 0.6

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.C2 = float(c.get("C2", self.C2))

    def _rapid_term(self, P6, trP):
        return -self.C2 * (
            P6 - (trP / 3.0)[:, None]
            * jnp.asarray(_I6, P6.dtype)[None, :])


class SpectEddyVisc(Smagorinsky):
    """Spectral eddy-viscosity SGS model (reference:
    LES/spectEddyVisc/spectEddyVisc.C): the SGS energy is the
    Kolmogorov spectrum integrated from the grid cutoff to the
    dissipation scale,

        eps = 2 nuEff |symm(grad U)|^2          (lagged nuEff)
        k   = cK1 (delta eps)^{2/3}
                  exp(-cK2 delta^{-4/3} nu eps^{-1/3})
            - cK3 sqrt(nu eps)
                  erfc(cK4 delta^{-2/3} sqrt(nu) eps^{-1/6})
        nuSgs = Ck delta sqrt(k)

    with the published spectral constants. The reference evaluates
    nuEff with the previous step's nuSgs (one-step lag) — same here."""

    name = "spectEddyVisc"
    cK1 = 0.83
    cK2 = 1.03
    cK3 = 4.75
    cK4 = 2.55

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("cK1", "cK2", "cK3", "cK4"):
            setattr(self, key, float(c.get(key, getattr(self, key))))

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        from jax.scipy.special import erfc

        from .base import production

        nut_f = tstate["nut"]
        delta = jnp.cbrt(mesh.v)
        _, S2 = production(mesh, jnp.zeros_like(mesh.v), U)
        eps = jnp.maximum(
            2.0 * (self.nu + nut_f.data) * 0.5 * S2, 1e-20)
        nu = self.nu
        k = (self.cK1 * (delta * eps) ** (2.0 / 3.0)
             * jnp.exp(-self.cK2 * delta ** (-4.0 / 3.0) * nu
                       * eps ** (-1.0 / 3.0))
             - self.cK3 * jnp.sqrt(nu * eps)
             * erfc(self.cK4 * delta ** (-2.0 / 3.0) * jnp.sqrt(nu)
                    * eps ** (-1.0 / 6.0)))
        k = jnp.maximum(k, 0.0)
        nut_new = self.Ck * delta * jnp.sqrt(k)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k, nu=self.nu, U=U.data)
        new = dict(tstate)
        new["nut"] = new_nut
        return new, {}


register("spectEddyVisc", SpectEddyVisc)
register("locDynOneEqEddy", LocDynOneEqEddy)
register("dynMixedSmagorinsky", DynMixedSmagorinsky)
register("DeardorffDiffStress", DeardorffDiffStress)
register("LRDDiffStress", LRDDiffStress)
