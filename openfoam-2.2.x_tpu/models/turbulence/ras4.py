"""Cubic nonlinear k-epsilon family, Lien-Leschziner low-Re, and
SA-IDDES.

Reference: src/turbulenceModels/incompressible/RAS/
  - LienCubicKE/          (cubic nonlinear k-epsilon, Lien, Chen &
                           Leschziner 1996)
  - LienCubicKELowRe/     (cubic + low-Re wall damping)
  - LienLeschzinerLowRe/  (linear low-Re k-epsilon, Lien &
                           Leschziner 1993)
and src/turbulenceModels/incompressible/LES/SpalartAllmarasIDDES/
(Shur, Spalart, Strelets & Travin 2008).

Design notes: the cubic terms of the Lien model that are
proportional to S enter as a strain/vorticity-dependent effective
viscosity (the reference's `C5viscosity_` field) — here this is
a per-cell expression folded into the nut update, so the cubic
model costs the same as the quadratic one. The quadratic stress
divergence rides the slot-table symmetric-tensor divergence
(ras2._div_symm_tensor). IDDES's blending functions are elementwise
over the wall-distance field; delta is cubeRootVol (the framework's
LESdelta — documented deviation from the reference's IDDESDelta
max-edge form)."""

from __future__ import annotations

from typing import Any, Tuple

import jax.numpy as jnp
import numpy as np

from ...core.fields import VolField
from ...ops import fvc
from .base import register
from .ras import EPS_MIN, K_MIN, KEpsilon, SpalartAllmarasDDES
from .ras3 import NonlinearKEShih


class LienCubicKE(NonlinearKEShih):
    """Lien cubic nonlinear k-epsilon (reference:
    RAS/LienCubicKE/LienCubicKE.C): the Shih quadratic stress plus the
    cubic contributions. In the Lien coefficient set the traceless
    cubic cross-term vanishes and the remaining cubic terms are
    proportional to S, so they enter as the strain/vorticity-dependent
    viscosity

        nut = Cmu k^2/eps - 2 Cmu^3 (k^4/eps^3)(|2S|^2 - |2W|^2)
            = [Cmu - 4 Cmu^3 (eta^2 - ksi^2)] k^2/eps

    (the reference's C5viscosity_), floored at a small positive
    fraction of the linear value for realizability."""

    name = "LienCubicKE"

    def _cmu_eff(self, eta, ksi):
        cmu = self._cmu_var(eta, ksi)
        # cubic correction factor clipped for realizability (nut > 0
        # and bounded) — at weak strain it is exactly 1 and the model
        # reduces to the quadratic form
        corr = jnp.clip(1.0 - 4.0 * cmu * cmu * (eta ** 2 - ksi ** 2),
                        0.05, 2.0)
        return cmu * corr

    def correct(self, mesh, tstate, U, phi, dt, steady=False,
                relax=1.0, controls=None, phi_slot=None, **kw):
        k = tstate["k"].data
        eps = tstate["epsilon"].data
        nls, g = self.nonlinear_stress(mesh, U, k, eps)
        G_extra = -jnp.sum(nls * g, axis=(1, 2))
        eta, ksi = self._eta_ksi(g, k, eps)
        fmu = self._cmu_eff(eta, ksi) / 0.09
        fmu_lowre, f2 = self._lowre_damping(k, eps)
        if fmu_lowre is not None:
            fmu = fmu * fmu_lowre
        return KEpsilon.correct(self, mesh, tstate, U, phi, dt,
                                steady=steady, relax=relax,
                                controls=controls, phi_slot=phi_slot,
                                fmu_field=fmu, c2_field=f2,
                                G_extra=G_extra)

    def _lowre_damping(self, k, eps):
        """Hook: (fMu multiplier on nut, C2 field) — high-Re: none."""
        return None, None


class LienCubicKELowRe(LienCubicKE):
    """Low-Re cubic Lien k-epsilon (reference:
    RAS/LienCubicKELowRe/LienCubicKELowRe.C): the cubic model
    integrated to the wall with the Lien-Leschziner damping

        yStar = sqrt(k) y / nu
        fMu   = (1 - exp(-Am yStar)) / (1 - exp(-Aeps yStar))
        f2    = 1 - 0.3 exp(-Rt^2),  Rt = k^2/(nu eps)

    (the reference's additional near-wall epsilon source is omitted —
    documented deviation; the wall-resolved mesh requirement y+ ~ 1 is
    the same)."""

    name = "LienCubicKELowRe"
    Am = 0.016
    Aepsilon = 0.263

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.Am = float(c.get("Am", self.Am))
        self.Aepsilon = float(c.get("Aepsilon", self.Aepsilon))
        self.y_wall = None

    def init_wall_distance(self, poly_mesh, dtype):
        from ...mesh.walldist import wall_distance

        y = wall_distance(poly_mesh)
        y = np.where(np.isfinite(y), y, 1e10)
        self.y_wall = jnp.asarray(np.maximum(y, 1e-10).astype(dtype))

    def _lowre_damping(self, k, eps):
        y_star = jnp.sqrt(jnp.maximum(k, K_MIN)) * self.y_wall / self.nu
        fmu = ((1.0 - jnp.exp(-self.Am * y_star))
               / jnp.maximum(1.0 - jnp.exp(-self.Aepsilon * y_star),
                             1e-6))
        fmu = jnp.clip(fmu, 1e-4, 1.0)
        Rt = k * k / (self.nu * jnp.maximum(eps, EPS_MIN))
        f2 = 1.0 - 0.3 * jnp.exp(-jnp.minimum(Rt * Rt, 50.0))
        return fmu, self.C2 * f2


class LienLeschzinerLowRe(KEpsilon):
    """Lien-Leschziner linear low-Re k-epsilon (reference:
    RAS/LienLeschzinerLowRe/LienLeschzinerLowRe.C; Lien & Leschziner
    1993): standard k-epsilon integrated to the wall with

        fMu = (1 - exp(-Am yStar)) / (1 - exp(-Aeps yStar))
        f2  = 1 - 0.3 exp(-Rt^2)

    epsilon wall BC zeroGradient, k = 0 at walls, y+ ~ 1 mesh."""

    name = "LienLeschzinerLowRe"
    Am = 0.016
    Aepsilon = 0.263

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.Am = float(c.get("Am", self.Am))
        self.Aepsilon = float(c.get("Aepsilon", self.Aepsilon))
        self.y_wall = None

    def init_wall_distance(self, poly_mesh, dtype):
        from ...mesh.walldist import wall_distance

        y = wall_distance(poly_mesh)
        y = np.where(np.isfinite(y), y, 1e10)
        self.y_wall = jnp.asarray(np.maximum(y, 1e-10).astype(dtype))

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None, **kw):
        k = tstate["k"].data
        eps = tstate["epsilon"].data
        y_star = jnp.sqrt(jnp.maximum(k, K_MIN)) * self.y_wall / self.nu
        fmu = ((1.0 - jnp.exp(-self.Am * y_star))
               / jnp.maximum(1.0 - jnp.exp(-self.Aepsilon * y_star),
                             1e-6))
        fmu = jnp.clip(fmu, 1e-4, 1.0)
        Rt = k * k / (self.nu * jnp.maximum(eps, EPS_MIN))
        f2 = 1.0 - 0.3 * jnp.exp(-jnp.minimum(Rt * Rt, 50.0))
        return super().correct(mesh, tstate, U, phi, dt, steady, relax,
                               controls, phi_slot=phi_slot,
                               fmu_field=fmu, c2_field=self.C2 * f2)


class SpalartAllmarasIDDES(SpalartAllmarasDDES):
    """Improved delayed DES (reference:
    LES/SpalartAllmarasIDDES/SpalartAllmarasIDDES.C; Shur et al.
    2008): blends the RANS and LES length scales with the wall-modeled
    LES branch,

        alpha = 0.25 - y/hmax
        fB  = min(2 exp(-9 alpha^2), 1)
        fe1 = 2 exp(-11.09 alpha^2)  (alpha >= 0)
              2 exp(-9 alpha^2)      (alpha <  0)
        fe2 = 1 - max(ft, fl);  ft = tanh((Ct^2 rdt)^3),
                                fl = tanh((Cl^2 rdl)^10)
        fe  = max(fe1 - 1, 0) fe2
        fdt = 1 - tanh((8 rdt)^3);  fdTilda = max(1 - fdt, fB)
        dTilda = max(fdTilda (1 + fe) y + (1 - fdTilda) CDES Delta,
                     1e-10)

    rdt/rdl use the eddy/molecular viscosity over kappa^2 y^2 |grad U|.
    hmax and Delta are cubeRootVol (documented deviation from the
    reference's IDDESDelta max-edge measure; psi low-Re correction
    taken as 1)."""

    name = "SpalartAllmarasIDDES"
    Ct = 1.63
    Cl = 3.55

    def __init__(self, nu, coeffs=None, y_wall=None):
        super().__init__(nu, coeffs, y_wall)
        c = self.coeffs or {}
        self.Ct = float(c.get("Ct", self.Ct))
        self.Cl = float(c.get("Cl", self.Cl))

    def init_wall_distance(self, poly_mesh, dtype):
        super().init_wall_distance(poly_mesh, dtype)
        self._hmax = jnp.asarray(
            np.cbrt(np.asarray(poly_mesh.v)).astype(dtype))

    def d_tilda(self, mesh, U, nuT_f):
        y = self.y_wall
        hmax = self._hmax
        g = fvc.grad(mesh, U)
        mag_gu = jnp.sqrt(jnp.maximum(jnp.sum(g * g, axis=(1, 2)),
                                      1e-20))
        denom = mag_gu * (self.kappa * y) ** 2 + 1e-20
        chi = nuT_f.data / self.nu
        nut = nuT_f.data * self._fv1(chi)
        rdt = jnp.minimum(nut / denom, 10.0)
        rdl = jnp.minimum(self.nu / denom, 10.0)
        alpha = 0.25 - y / hmax
        fB = jnp.minimum(2.0 * jnp.exp(-9.0 * alpha ** 2), 1.0)
        ft = jnp.tanh((self.Ct ** 2 * rdt) ** 3)
        fl = jnp.tanh((self.Cl ** 2 * rdl) ** 10)
        fe2 = 1.0 - jnp.maximum(ft, fl)
        fe1 = jnp.where(alpha >= 0.0,
                        2.0 * jnp.exp(-11.09 * alpha ** 2),
                        2.0 * jnp.exp(-9.0 * alpha ** 2))
        fe = jnp.maximum(fe1 - 1.0, 0.0) * fe2
        fdt = 1.0 - jnp.tanh((8.0 * rdt) ** 3)
        fd = jnp.maximum(1.0 - fdt, fB)
        return jnp.maximum(
            fd * (1.0 + fe) * y + (1.0 - fd) * self._cdes_delta,
            1e-10)


register("LienCubicKE", LienCubicKE)
register("LienCubicKELowRe", LienCubicKELowRe)
register("LienLeschzinerLowRe", LienLeschzinerLowRe)
register("SpalartAllmarasIDDES", SpalartAllmarasIDDES)
