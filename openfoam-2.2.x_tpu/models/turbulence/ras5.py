"""kkLOmega: the Walters-Cokljat three-equation laminar-kinetic-energy
transition model.

Reference: src/turbulenceModels/incompressible/RAS/kkLOmega/kkLOmega.C
(Walters & Cokljat 2008, J. Fluids Eng. 130). Transports turbulent
kinetic energy kT, LAMINAR kinetic energy kL (streamwise Klebanoff
modes in the pre-transitional boundary layer), and the specific
dissipation rate omega; bypass and natural transition are modelled by
transfer terms R_BP/R_NAT that move energy from kL to kT.

Design notes: all ~15 damping/transition functions are elementwise
expressions over (kT, kL, omega, |S|, |Omega|, y); the three
transport equations ride the shared slot-form transport assembly
(ras._transport_ops) and Krylov path. The wall distance is the static
KD-tree field (mesh/walldist.py). Model constants are the published
Walters-Cokljat values (the reference's defaults)."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp
import numpy as np

from ...core.dimensions import dimViscosity
from ...core.fields import VolField
from ...ops import fvc, fvm
from .base import TurbulenceModel, bound_below, register
from .ras import (EPS_MIN, K_MIN, OMEGA_MIN, _gamma_forms, _phi_slotform,
                  _solve_transport, _transport_ops)


class KKLOmega(TurbulenceModel):
    """Walters-Cokljat kT-kL-omega transitional model (reference:
    RAS/kkLOmega/). Integrates to the wall: kT = kL = 0 and omega
    zeroGradient wall BCs, y+ ~ 1 mesh."""

    name = "kkLOmega"
    field_names = ("kt", "kl", "omega", "nut")

    A0 = 4.04
    As = 2.12
    Av = 6.75
    Abp = 0.6
    Anat = 200.0
    Ats = 200.0
    CbpCrit = 1.2
    Cnc = 0.1
    CnatCrit = 1250.0
    Cint = 0.75
    CtsCrit = 1000.0
    CrNat = 0.02
    C11 = 3.4e-6
    C12 = 1.0e-10
    CR = 0.12
    CalphaTheta = 0.035
    Css = 1.5
    CtauL = 4360.0
    Cw1 = 0.44
    Cw2 = 0.92
    Cw3 = 0.3
    CwR = 1.5
    Clambda = 2.495
    CmuStd = 0.09
    Sigmak = 1.0
    Sigmaw = 1.17

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("A0", "As", "Av", "Abp", "Anat", "Ats", "CbpCrit",
                    "Cnc", "CnatCrit", "Cint", "CtsCrit", "CrNat",
                    "C11", "C12", "CR", "CalphaTheta", "Css", "CtauL",
                    "Cw1", "Cw2", "Cw3", "CwR", "Clambda", "CmuStd",
                    "Sigmak", "Sigmaw"):
                setattr(self, key, float(c.get(key, getattr(self, key))))
        self.y_wall = None

    def init_wall_distance(self, poly_mesh, dtype):
        from ...mesh.walldist import wall_distance

        y = wall_distance(poly_mesh)
        y = np.where(np.isfinite(y), y, 1e10)
        self.y_wall = jnp.asarray(np.maximum(y, 1e-10).astype(dtype))

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    # -- model functions (Walters & Cokljat 2008, Table 1) -----------------
    def _functions(self, kt, kl, omega, S2, W2):
        nu = self.nu
        y = self.y_wall
        S = jnp.sqrt(jnp.maximum(S2, 1e-20))
        Om = jnp.sqrt(jnp.maximum(W2, 1e-20))
        kt_s = jnp.maximum(kt, K_MIN)
        om_s = jnp.maximum(omega, OMEGA_MIN)

        lambdaT = jnp.sqrt(kt_s) / om_s
        lambdaEff = jnp.minimum(self.Clambda * y, lambdaT)
        fW = (lambdaEff / jnp.maximum(lambdaT, 1e-20)) ** (2.0 / 3.0)
        fSS = jnp.exp(-((self.Css * nu * Om / kt_s) ** 2))
        ktS = fSS * fW * kt                      # small-scale TKE
        ktL = jnp.maximum(kt - ktS, 0.0)         # large-scale TKE
        ReT = fW ** 2 * kt_s / (nu * om_s)
        fNu = 1.0 - jnp.exp(-jnp.sqrt(jnp.maximum(ReT, 0.0)) / self.Av)
        fINT = jnp.minimum(kt / (self.Cint
                                 * jnp.maximum(kl + kt, K_MIN)), 1.0)
        Cmu = 1.0 / (self.A0 + self.As * S / om_s)
        nuts = fNu * fINT * Cmu * jnp.sqrt(jnp.maximum(ktS, 0.0)) \
            * lambdaEff
        # large-scale / laminar production viscosity
        ReOmega = y ** 2 * Om / nu
        betaTS = 1.0 - jnp.exp(
            -jnp.maximum(ReOmega - self.CtsCrit, 0.0) ** 2 / self.Ats)
        fTaul = 1.0 - jnp.exp(
            -self.CtauL * ktL
            / jnp.maximum((lambdaEff * Om) ** 2, 1e-20))
        nutl = (self.C11 * fTaul * Om * lambdaEff ** 2
                * jnp.sqrt(jnp.maximum(ktL, 0.0)) * lambdaEff / nu
                + self.C12 * betaTS * ReOmega * y ** 2 * Om)
        nutl = jnp.minimum(nutl,
                           0.5 * (kl + ktL) / jnp.maximum(S, 1e-10))
        # bypass/natural transition transfer rates (per unit kL)
        phiBP = jnp.clip(kt / (nu * Om) - self.CbpCrit, 0.0, 50.0)
        betaBP = 1.0 - jnp.exp(-phiBP / self.Abp)
        R_BP = self.CR * betaBP * omega / jnp.maximum(fW, 1e-6)
        fNatCrit = 1.0 - jnp.exp(
            -self.Cnc * jnp.sqrt(jnp.maximum(kl, 0.0)) * y / nu)
        betaNAT = 1.0 - jnp.exp(
            -jnp.maximum(ReOmega
                         - self.CnatCrit
                         / jnp.maximum(fNatCrit, 1e-6), 0.0)
            / self.Anat)
        R_NAT = self.CrNat * betaNAT * Om
        fOmega = 1.0 - jnp.exp(
            -0.41 * (lambdaEff / jnp.maximum(lambdaT, 1e-20)) ** 4)
        alphaT = fNu * self.CmuStd * jnp.sqrt(jnp.maximum(ktS, 0.0)) \
            * lambdaEff
        return dict(lambdaEff=lambdaEff, fW=fW, ktS=ktS, ktL=ktL,
                    nuts=nuts, nutl=nutl, R_BP=R_BP, R_NAT=R_NAT,
                    fOmega=fOmega, alphaT=alphaT, S=S, Om=Om)

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        from ...ops import slot as slot_mod
        from ...ops import surface as surface_mod

        kt_f: VolField = tstate["kt"]
        kl_f: VolField = tstate["kl"]
        om_f: VolField = tstate["omega"]
        nut_f: VolField = tstate["nut"]
        kt, kl, omega = kt_f.data, kl_f.data, om_f.data
        rdt = 1.0 / dt
        diag: Dict = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        g = fvc.grad(mesh, U)
        Ssym = 0.5 * (g + jnp.swapaxes(g, 1, 2))
        Wskw = 0.5 * (g - jnp.swapaxes(g, 1, 2))
        S2 = 2.0 * jnp.sum(Ssym * Ssym, axis=(1, 2))
        W2 = 2.0 * jnp.sum(Wskw * Wskw, axis=(1, 2))
        f = self._functions(kt, kl, omega, S2, W2)

        PkT = f["nuts"] * S2
        PkL = f["nutl"] * S2
        transfer = (f["R_BP"] + f["R_NAT"]) * kl   # kL -> kT
        # wall dissipation D = 2 nu |grad sqrt(k)|^2 (anisotropic
        # near-wall dissipation, reference kkLOmega.C)
        sqkt = kt_f.with_data(jnp.sqrt(jnp.maximum(kt, 0.0)))
        sqkl = kl_f.with_data(jnp.sqrt(jnp.maximum(kl, 0.0)))
        DT = 2.0 * self.nu * jnp.sum(fvc.grad(mesh, sqkt) ** 2, axis=1)
        DL = 2.0 * self.nu * jnp.sum(fvc.grad(mesh, sqkl) ** 2, axis=1)

        def diff_slot(alpha_over_sigma):
            gam = self.nu + alpha_over_sigma
            sl = slot_mod.interpolate(
                mesh, gam, bv=surface_mod.owner_to_b(mesh, gam))
            return slot_mod.to_flat(mesh, sl), sl

        kt_s = jnp.maximum(kt, K_MIN)
        # kT equation
        gam_f, gam_sl = diff_slot(f["alphaT"] / self.Sigmak)
        ddt_kt = (fvm.ddt(mesh, kt_f, kt, rdt) if not steady
                  else fvm.ddt_steady(mesh, kt_f))
        kt_eqn = (
            ddt_kt
            + _transport_ops(mesh, phi, phi_sl, kt_f, self.div_scheme,
                             gam_f, gam_sl, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, omega + DT / kt_s, kt_f)
        )
        kt_eqn = kt_eqn.add_source(PkT + transfer, mesh)
        if steady and relax < 1.0:
            kt_eqn = kt_eqn.relax(mesh, relax, kt)
        kt_new, perf = _solve_transport(mesh, kt_f, kt_eqn, controls)
        kt_new = bound_below(kt_new, K_MIN)
        diag["kt"] = perf

        # kL equation (molecular diffusion only — reference kkLOmega)
        nu_flat = jnp.asarray(self.nu, kt.dtype)
        ddt_kl = (fvm.ddt(mesh, kl_f, kl, rdt) if not steady
                  else fvm.ddt_steady(mesh, kl_f))
        kl_eqn = (
            ddt_kl
            + _transport_ops(mesh, phi, phi_sl, kl_f, self.div_scheme,
                             nu_flat, None, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, f["R_BP"] + f["R_NAT"]
                     + DL / jnp.maximum(kl, K_MIN), kl_f)
        )
        kl_eqn = kl_eqn.add_source(PkL, mesh)
        if steady and relax < 1.0:
            kl_eqn = kl_eqn.relax(mesh, relax, kl)
        kl_new, perf = _solve_transport(mesh, kl_f, kl_eqn, controls)
        kl_new = bound_below(kl_new, K_MIN)
        diag["kl"] = perf

        # omega equation
        gam_f, gam_sl = diff_slot(f["alphaT"] / self.Sigmaw)
        ddt_om = (fvm.ddt(mesh, om_f, omega, rdt) if not steady
                  else fvm.ddt_steady(mesh, om_f))
        om_eqn = (
            ddt_om
            + _transport_ops(mesh, phi, phi_sl, om_f, self.div_scheme,
                             gam_f, gam_sl, self.corrected,
                             self.corr_limit)
            + fvm.Sp(mesh, self.Cw2 * f["fW"] ** 2 * omega, om_f)
        )
        src_om = (self.Cw1 * PkT * omega / kt_s
                  + (self.CwR / jnp.maximum(f["fW"], 1e-6) - 1.0)
                  * omega / kt_s * transfer
                  + self.Cw3 * f["fOmega"] * f["alphaT"]
                  * f["fW"] ** 2 * jnp.sqrt(kt_s) / self.y_wall ** 3)
        om_eqn = om_eqn.add_source(src_om, mesh)
        if steady and relax < 1.0:
            om_eqn = om_eqn.relax(mesh, relax, omega)
        om_new, perf = _solve_transport(mesh, om_f, om_eqn, controls)
        om_new = bound_below(om_new, OMEGA_MIN)
        diag["omega"] = perf

        f_new = self._functions(kt_new, kl_new, om_new, S2, W2)
        nut_new = jnp.maximum(f_new["nuts"] + f_new["nutl"], 0.0)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=kt_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(kt=kt_f.with_data(kt_new), kl=kl_f.with_data(kl_new),
                   omega=om_f.with_data(om_new), nut=new_nut)
        return new, diag


register("kkLOmega", KKLOmega)
