"""Nonlinear (quadratic) eddy-viscosity RAS closures.

Reference: src/turbulenceModels/incompressible/RAS/NonlinearKEShih/
(Shih, Zhu & Lumley quadratic k-epsilon). The cubic LienCubicKE family
shares the same machinery but is NOT implemented — documented gap.

Design notes: the nonlinear stress is an elementwise [nC,3,3] expression
of grad(U) (pure elementwise work); its divergence rides the same slot-table
tensor-divergence used by the Reynolds-stress-transport models
(ras2._div_symm_tensor). The variable Cmu and the nonlinear stress are
evaluated from the previous iteration's k/epsilon (one-iteration lag;
converges to the reference fixed point — documented deviation from the
in-loop update).
"""

from __future__ import annotations

from typing import Any, Tuple

import jax.numpy as jnp

from ...core.fields import VolField
from ...ops import fvc
from .base import register
from .ras import EPS_MIN, K_MIN, KEpsilon
from .ras2 import _div_symm_tensor, full_to_symm


class NonlinearKEShih(KEpsilon):
    """Shih quadratic nonlinear k-epsilon (reference:
    RAS/NonlinearKEShih/NonlinearKEShih.C):

        eta = (k/eps) sqrt(2 S:S),  ksi = (k/eps) sqrt(2 W:W)
        Cmu = (2/3) / (A1 + eta + alphaKsi ksi)
        fEta = A2 + eta^3
        NLS = symm( (k^3/eps^2) [ Ctau1/fEta (gU.gU + (gU.gU)^T)
                                 + Ctau2/fEta (gU.gU^T)
                                 + Ctau3/fEta (gU^T.gU) ] )
        divDevReff += fvc::div(NLS);  G -= NLS && grad(U)
    """

    name = "NonlinearKEShih"
    field_names = ("k", "epsilon", "nut")

    C1 = 1.44
    C2 = 1.92
    sigma_k = 1.0
    sigma_eps = 1.3
    A1 = 1.25
    A2 = 1000.0
    Ctau1 = -4.0
    Ctau2 = 13.0
    Ctau3 = -2.0
    alphaKsi = 0.9

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("A1", "A2", "Ctau1", "Ctau2", "Ctau3", "alphaKsi"):
            setattr(self, key, float(c.get(key, getattr(self, key))))

    # -- invariants + nonlinear stress ---------------------------------------
    def _eta_ksi(self, g, k, eps):
        S = 0.5 * (g + jnp.swapaxes(g, 1, 2))
        W = 0.5 * (g - jnp.swapaxes(g, 1, 2))
        ke = k / jnp.maximum(eps, EPS_MIN)
        eta = ke * jnp.sqrt(2.0 * jnp.sum(S * S, axis=(1, 2)))
        ksi = ke * jnp.sqrt(2.0 * jnp.sum(W * W, axis=(1, 2)))
        return eta, ksi

    def _cmu_var(self, eta, ksi):
        return (2.0 / 3.0) / (self.A1 + eta + self.alphaKsi * ksi)

    def nonlinear_stress(self, mesh, U: VolField, k, eps
                         ) -> Tuple[Any, Any]:
        """-> (NLS [nC,3,3], grad U). Stress in kinematic units
        [m^2/s^2]."""
        g = fvc.grad(mesh, U)                    # g[c,i,j] = d_i u_j
        eta, _ = self._eta_ksi(g, k, eps)
        fEta = self.A2 + eta ** 3
        k3e2 = (jnp.maximum(k, K_MIN) ** 3
                / jnp.maximum(eps, EPS_MIN) ** 2 / fEta)
        gg = jnp.einsum("cik,ckj->cij", g, g)
        ggT = jnp.einsum("cik,cjk->cij", g, g)   # gU . gU^T
        gTg = jnp.einsum("cki,ckj->cij", g, g)   # gU^T . gU
        t = (self.Ctau1 * (gg + jnp.swapaxes(gg, 1, 2))
             + self.Ctau2 * ggT + self.Ctau3 * gTg)
        t = k3e2[:, None, None] * t
        return 0.5 * (t + jnp.swapaxes(t, 1, 2)), g

    # -- coupling --------------------------------------------------------------
    def _nut_from(self, k, eps):
        # variable-Cmu nut is applied through fmu_field in correct();
        # this base form only seeds the very first state
        return 0.09 * k * k / jnp.maximum(eps, EPS_MIN)

    def div_dev_reff(self, mesh, tstate, U: VolField):
        mat, expl = super().div_dev_reff(mesh, tstate, U)
        nls, _ = self.nonlinear_stress(
            mesh, U, tstate["k"].data, tstate["epsilon"].data)
        div_nls = _div_symm_tensor(mesh, full_to_symm(nls))
        return mat, expl + div_nls

    def correct(self, mesh, tstate, U, phi, dt, steady=False,
                relax=1.0, controls=None, phi_slot=None, **kw):
        k = tstate["k"].data
        eps = tstate["epsilon"].data
        nls, g = self.nonlinear_stress(mesh, U, k, eps)
        G_extra = -jnp.sum(nls * g, axis=(1, 2))
        eta, ksi = self._eta_ksi(g, k, eps)
        fmu = self._cmu_var(eta, ksi) / 0.09
        return super().correct(mesh, tstate, U, phi, dt, steady=steady,
                               relax=relax, controls=controls,
                               phi_slot=phi_slot, fmu_field=fmu,
                               G_extra=G_extra)


register("NonlinearKEShih", NonlinearKEShih)
