"""Additional RAS closures: low-Re k-epsilon variants, the v2-f
four-equation model, Reynolds-stress transport, and SST-SAS.

Reference: src/turbulenceModels/incompressible/RAS/
  - LamBremhorstKE/   (low-Re damped k-epsilon)
  - qZeta/            (q = sqrt(k), zeta = eps/2q low-Re variables)
  - v2f/              (Lien-Kalitzin elliptic-relaxation, N=6 form)
  - LRR/              (Launder-Reece-Rodi Reynolds-stress transport)
  - LaunderGibsonRSTM/ (LRR + Gibson-Launder wall reflection)
  - kOmegaSSTSAS/     (Menter-Egorov scale-adaptive SST)

Design notes: the Reynolds-stress models transport R as a single
[nC, 6] symmetric-tensor field solved with the multi-RHS Krylov path
(one matrix, six right-hand sides — the same mechanism the segregated
fvVectorMatrix solve uses), so an RSTM step costs barely more than a
k-epsilon step in elementwise arithmetic. All damping functions are standard
published closures (Lam & Bremhorst 1981; Gibson & Dafa'Alla 1995;
Lien & Kalitzin 2001; Launder, Reece & Rodi 1975; Gibson & Launder
1978; Menter & Egorov 2010).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ...core.dimensions import dimViscosity
from ...core.fields import VolField
from ...ops import fvc, fvm
from .base import TurbulenceModel, bound_below, production, register
from .ras import (EPS_MIN, K_MIN, OMEGA_MIN, _CMU, _KAPPA, KEpsilon,
                  KOmegaSST, _gamma_forms, _has_wall_fn, _phi_slotform,
                  _solve_transport, _transport_ops, _wall_data,
                  _wall_face_nut)

# symmetric-tensor component order (xx, xy, xz, yy, yz, zz) — the
# reference's symmTensor layout (src/OpenFOAM/primitives/SymmTensor).
_SYMM_IDX = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def symm_to_full(R6: Any) -> Any:
    """[nC,6] (xx,xy,xz,yy,yz,zz) -> [nC,3,3]."""
    xx, xy, xz, yy, yz, zz = (R6[:, i] for i in range(6))
    row0 = jnp.stack([xx, xy, xz], axis=1)
    row1 = jnp.stack([xy, yy, yz], axis=1)
    row2 = jnp.stack([xz, yz, zz], axis=1)
    return jnp.stack([row0, row1, row2], axis=1)


def full_to_symm(T: Any) -> Any:
    """[nC,3,3] (assumed symmetric) -> [nC,6]."""
    return jnp.stack([T[:, 0, 0], T[:, 0, 1], T[:, 0, 2],
                      T[:, 1, 1], T[:, 1, 2], T[:, 2, 2]], axis=1)


def _div_symm_tensor(mesh, R6: Any) -> Any:
    """(1/V) sum_f Sf . R_f for a cell symmTensor field -> [nC,3]
    (zero-gradient extrapolation on boundaries, as fvc::div(R) with
    the calculated patch evaluation). Slot-form assembly, gather-free
    on the structured interior (ops/slot.py)."""
    from ...ops import slot as slot_mod

    T = symm_to_full(R6)                             # [nC,3,3]
    tf = slot_mod.interpolate(mesh, T.reshape(-1, 9))
    sv = tf.sv.reshape(tf.sv.shape[:2] + (3, 3))
    flux_sv = jnp.einsum("cmi,cmij->cmj", mesh.st_sf, sv)
    div_t = jnp.sum(flux_sv * mesh.st_valid[:, :, None], axis=1)
    if mesh.fb_cells.shape[0]:
        fbt = tf.fb.reshape(-1, 3, 3)
        flux_fb = jnp.einsum("fi,fij->fj", mesh.fb_sf, fbt)
        div_t = div_t.at[mesh.fb_cells].add(flux_fb)
    flux_b = jnp.einsum("fi,fij->fj", mesh.ab_sf, T[mesh.ab_owner])
    div_t = div_t.at[mesh.ab_owner].add(flux_b)
    return div_t / mesh.v[:, None]


class LamBremhorstKE(KEpsilon):
    """Lam-Bremhorst low-Re k-epsilon (reference:
    RAS/LamBremhorstKE/LamBremhorstKE.C): damping functions fMu
    (on nut), f1 (on C1), f2 (on C2) built from Rt = k^2/(nu eps) and
    Ry = sqrt(k) y / nu. Integrates to the wall — no wall functions;
    epsilon wall BC is zeroGradient and the mesh must resolve y+ ~ 1."""

    name = "LamBremhorstKE"

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
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
        Rt = k * k / (self.nu * jnp.maximum(eps, EPS_MIN))
        Ry = jnp.sqrt(jnp.maximum(k, K_MIN)) * self.y_wall / self.nu
        fmu = (1.0 - jnp.exp(-0.0165 * Ry)) ** 2 \
            * (1.0 + 20.5 / jnp.maximum(Rt, 1e-3))
        fmu = jnp.clip(fmu, 1e-4, 1.0)
        f1 = 1.0 + (0.05 / fmu) ** 3
        f2 = 1.0 - jnp.exp(-Rt * Rt)
        return super().correct(
            mesh, tstate, U, phi, dt, steady, relax, controls,
            c1_field=self.C1 * f1, phi_slot=phi_slot,
            c2_field=self.C2 * f2, fmu_field=fmu)


class QZeta(TurbulenceModel):
    """q-zeta low-Re k-epsilon (reference: RAS/qZeta/qZeta.C).
    q = sqrt(k), zeta = eps/(2q); the transported equations follow
    from the k/eps pair by that change of variables (so the high-Re
    limit is exactly kEpsilon), with the low-Re damping
    fMu = exp(-6/(1+Rt/50)^2), f2 = 1 - 0.3 exp(-Rt^2). State is kept
    as (k, epsilon) so cases need no extra 0/ fields."""

    name = "qZeta"
    field_names = ("k", "epsilon", "nut")

    Cmu = _CMU
    C1 = 1.44
    C2 = 1.92
    sigmaZeta = 1.3

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.C1 = float(c.get("C1", self.C1))
        self.C2 = float(c.get("C2", self.C2))
        self.sigmaZeta = float(c.get("sigmaZeta", self.sigmaZeta))

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        k_f, eps_f, nut_f = tstate["k"], tstate["epsilon"], tstate["nut"]
        k = jnp.maximum(k_f.data, K_MIN)
        eps = jnp.maximum(eps_f.data, EPS_MIN)
        nut = nut_f.data
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        q = jnp.sqrt(k)
        zeta = eps / (2.0 * q)
        q_f = k_f.with_data(q)          # reuse k's BCs (zeroGradient/fixed)
        zeta_f = eps_f.with_data(zeta)

        Rt = k * k / (self.nu * eps)
        fmu = jnp.exp(-6.0 / (1.0 + Rt / 50.0) ** 2)
        f2 = 1.0 - 0.3 * jnp.exp(-(Rt ** 2))
        G, S2 = production(mesh, nut, U)

        # zeta equation: (2C1-1) G zeta/(2k) explicit,
        # Sp((2 C2 f2 - 1) zeta / q) implicit  [change-of-variables form]
        z_flat, z_slot = _gamma_forms(mesh, self.nu, nut_f, self.sigmaZeta)
        ddt_z = (fvm.ddt(mesh, zeta_f, zeta, rdt) if not steady
                 else fvm.ddt_steady(mesh, zeta_f))
        z_eqn = (
            ddt_z
            + _transport_ops(mesh, phi, phi_sl, zeta_f, self.div_scheme,
                             z_flat, z_slot, self.corrected, self.corr_limit)
            + fvm.Sp(mesh, (2.0 * self.C2 * f2 - 1.0) * zeta / q, zeta_f)
        )
        z_eqn = z_eqn.add_source((2.0 * self.C1 - 1.0) * G * zeta
                                 / (2.0 * k), mesh)
        if steady and relax < 1.0:
            z_eqn = z_eqn.relax(mesh, relax, zeta)
        zeta_new, perf_z = _solve_transport(mesh, zeta_f, z_eqn, controls)
        zeta_new = bound_below(zeta_new, EPS_MIN)
        diag["zeta"] = perf_z

        # q equation: G/(2q) explicit, Sp(zeta/q) implicit
        q_flat, q_slot = _gamma_forms(mesh, self.nu, nut_f, 1.0)
        ddt_q = (fvm.ddt(mesh, q_f, q, rdt) if not steady
                 else fvm.ddt_steady(mesh, q_f))
        q_eqn = (
            ddt_q
            + _transport_ops(mesh, phi, phi_sl, q_f, self.div_scheme,
                             q_flat, q_slot, self.corrected, self.corr_limit)
            + fvm.Sp(mesh, zeta_new / q, q_f)
        )
        q_eqn = q_eqn.add_source(G / (2.0 * q), mesh)
        if steady and relax < 1.0:
            q_eqn = q_eqn.relax(mesh, relax, q)
        q_new, perf_q = _solve_transport(mesh, q_f, q_eqn, controls)
        q_new = bound_below(q_new, 1e-5)
        diag["q"] = perf_q

        k_new = q_new * q_new
        eps_new = 2.0 * q_new * zeta_new
        Rt_new = k_new * k_new / (self.nu * jnp.maximum(eps_new, EPS_MIN))
        fmu_new = jnp.exp(-6.0 / (1.0 + Rt_new / 50.0) ** 2)
        nut_new = self.Cmu * fmu_new * k_new * k_new \
            / jnp.maximum(eps_new, EPS_MIN)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), epsilon=eps_f.with_data(eps_new),
                   nut=new_nut)
        return new, diag


class V2F(TurbulenceModel):
    """v2-f model, Lien-Kalitzin (2001) N=6 'code-friendly' form
    (reference: RAS/v2f/v2f.C, added in 2.1.0):
        nut  = min(Cmu v2 T, CmuKEps k^2/eps)
        T    = max(k/eps, 6 sqrt(nu/eps))
        L    = CL max(k^1.5/eps, Ceta (nu^3/eps)^0.25)
        f    from the elliptic relaxation L^2 lap(f) - f = rhs
    Integrates to the wall (no wall functions). Case needs 0/v2 and 0/f."""

    name = "v2f"
    field_names = ("k", "epsilon", "v2", "f", "nut")

    Cmu = 0.22
    CmuKEps = 0.09
    C1 = 1.4
    C2 = 0.3
    CL = 0.23
    Ceta = 70.0
    Ceps2 = 1.9
    sigmaK = 1.0
    sigmaEps = 1.3
    N = 6.0

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("Cmu", "CmuKEps", "C1", "C2", "CL", "Ceta", "Ceps2",
                    "sigmaK", "sigmaEps"):
            setattr(self, key, float(c.get(key, getattr(self, key))))

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def _scales(self, k, eps):
        T = jnp.maximum(k / eps, 6.0 * jnp.sqrt(self.nu / eps))
        L = self.CL * jnp.maximum(
            k ** 1.5 / eps, self.Ceta * (self.nu ** 3 / eps) ** 0.25)
        return T, L

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        from ...ops import slot as slot_mod

        k_f, eps_f = tstate["k"], tstate["epsilon"]
        v2_f, f_f, nut_f = tstate["v2"], tstate["f"], tstate["nut"]
        k = jnp.maximum(k_f.data, K_MIN)
        eps = jnp.maximum(eps_f.data, EPS_MIN)
        v2 = jnp.maximum(v2_f.data, K_MIN)
        nut = nut_f.data
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        G, S2 = production(mesh, nut, U)
        T, L = self._scales(k, eps)

        # epsilon equation (Ceps1 grows near the wall via sqrt(k/v2))
        ceps1 = 1.4 * (1.0 + 0.05 * jnp.minimum(jnp.sqrt(k / v2), 100.0))
        e_flat, e_slot = _gamma_forms(mesh, self.nu, nut_f, self.sigmaEps)
        ddt_e = (fvm.ddt(mesh, eps_f, eps, rdt) if not steady
                 else fvm.ddt_steady(mesh, eps_f))
        e_eqn = (
            ddt_e
            + _transport_ops(mesh, phi, phi_sl, eps_f, self.div_scheme,
                             e_flat, e_slot, self.corrected, self.corr_limit)
            + fvm.Sp(mesh, self.Ceps2 / T, eps_f)
        )
        e_eqn = e_eqn.add_source(ceps1 * G / T, mesh)
        if steady and relax < 1.0:
            e_eqn = e_eqn.relax(mesh, relax, eps)
        eps_new, perf_e = _solve_transport(mesh, eps_f, e_eqn, controls)
        eps_new = bound_below(eps_new, EPS_MIN)
        diag["epsilon"] = perf_e

        # k equation
        k_flat, k_slot = _gamma_forms(mesh, self.nu, nut_f, self.sigmaK)
        ddt_k = (fvm.ddt(mesh, k_f, k, rdt) if not steady
                 else fvm.ddt_steady(mesh, k_f))
        k_eqn = (
            ddt_k
            + _transport_ops(mesh, phi, phi_sl, k_f, self.div_scheme,
                             k_flat, k_slot, self.corrected, self.corr_limit)
            + fvm.Sp(mesh, eps_new / k, k_f)
        )
        k_eqn = k_eqn.add_source(G, mesh)
        if steady and relax < 1.0:
            k_eqn = k_eqn.relax(mesh, relax, k)
        k_new, perf_k = _solve_transport(mesh, k_f, k_eqn, controls)
        k_new = bound_below(k_new, K_MIN)
        diag["k"] = perf_k

        # elliptic relaxation: -lap(L^2, f) + f = C2 G/k
        #   - (1/T) [ (C1 - N) v2/k - (2/3)(C1 - 1) ]
        from ...ops import surface as surface_mod
        L2_slot = slot_mod.interpolate(
            mesh, L * L, bv=surface_mod.owner_to_b(mesh, L * L))
        f_eqn = (
            -fvm.laplacian(mesh, slot_mod.to_flat(mesh, L2_slot), f_f,
                           corrected=self.corrected,
                           gamma_dims=dimViscosity,
                           limit=self.corr_limit, gamma_slot=L2_slot)
            + fvm.Sp(mesh, jnp.ones_like(k), f_f)
        )
        rhs_f = (self.C2 * G / k_new
                 - ((self.C1 - self.N) * v2 / k_new
                    - (2.0 / 3.0) * (self.C1 - 1.0)) / T)
        f_eqn = f_eqn.add_source(rhs_f, mesh)
        f_new, perf_f = _solve_transport(mesh, f_f, f_eqn, controls)
        f_new = jnp.maximum(f_new, 0.0)
        diag["f"] = perf_f

        # v2 equation: k*f source, N eps/k destruction
        v_flat, v_slot = _gamma_forms(mesh, self.nu, nut_f, self.sigmaK)
        ddt_v = (fvm.ddt(mesh, v2_f, v2, rdt) if not steady
                 else fvm.ddt_steady(mesh, v2_f))
        v_eqn = (
            ddt_v
            + _transport_ops(mesh, phi, phi_sl, v2_f, self.div_scheme,
                             v_flat, v_slot, self.corrected, self.corr_limit)
            + fvm.Sp(mesh, self.N * eps_new / k_new, v2_f)
        )
        v_eqn = v_eqn.add_source(k_new * f_new, mesh)
        if steady and relax < 1.0:
            v_eqn = v_eqn.relax(mesh, relax, v2)
        v2_new, perf_v = _solve_transport(mesh, v2_f, v_eqn, controls)
        v2_new = jnp.clip(v2_new, K_MIN, (2.0 / 3.0) * k_new * 1.5)
        diag["v2"] = perf_v

        T_new, _ = self._scales(k_new, eps_new)
        nut_new = jnp.minimum(self.Cmu * v2_new * T_new,
                              self.CmuKEps * k_new * k_new / eps_new)
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(k=k_f.with_data(k_new), epsilon=eps_f.with_data(eps_new),
                   v2=v2_f.with_data(v2_new), f=f_f.with_data(f_new),
                   nut=new_nut)
        return new, diag


class LRR(TurbulenceModel):
    """Launder-Reece-Rodi Reynolds-stress transport (reference:
    RAS/LRR/LRR.C). Transports the full symmetric Reynolds-stress
    tensor R [nC,6] with one matrix and six right-hand sides (the
    multi-RHS Krylov path), plus the standard epsilon equation:

        P_ij = -(R_ik dU_j/dx_k + R_jk dU_i/dx_k)
        REqn: ddt(R) + div(phi,R) - lap(DREff) + Sp(Clrr1 eps/k)
              == P + (2/3)(Clrr1 - 1) eps I - Clrr2 dev(P)
        DREff = nu + Cs k^2/eps;  DepsEff = nu + Ceps k^2/eps
        k = tr(R)/2;  nut = Cmu k^2/eps  (for divDevReff coupling)

    divDevReff(U) = fvc::div(R) + fvc::laplacian(nut, U)
                  - fvm::laplacian(nuEff, U)  [reference LRR.C]."""

    name = "LRR"
    field_names = ("R", "epsilon", "k", "nut")

    Cmu = _CMU
    Clrr1 = 1.8
    Clrr2 = 0.6
    C1 = 1.44
    C2 = 1.92
    Cs = 0.25
    Ceps = 0.15

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        for key in ("Cmu", "Clrr1", "Clrr2", "C1", "C2", "Cs", "Ceps"):
            setattr(self, key, float(c.get(key, getattr(self, key))))

    def nut(self, mesh, tstate):
        return tstate["nut"].data

    def _pressure_strain_extra(self, mesh, tstate, U, R6, P6, k, eps):
        """Hook for LaunderGibson wall-reflection terms."""
        return None

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        from ...ops import slot as slot_mod

        R_f, eps_f = tstate["R"], tstate["epsilon"]
        k_f, nut_f = tstate["k"], tstate["nut"]
        R6 = R_f.data                                 # [nC,6]
        eps = jnp.maximum(eps_f.data, EPS_MIN)
        nut = nut_f.data
        rdt = 1.0 / dt
        diag = {}
        phi_sl = _phi_slotform(mesh, phi, phi_slot)

        k = jnp.maximum(0.5 * (R6[:, 0] + R6[:, 3] + R6[:, 5]), K_MIN)
        g = fvc.grad(mesh, U)                         # g[c,i,j] = d_i u_j
        Rfull = symm_to_full(R6)
        # P = -twoSymm(R & gradU): (R & gradU)_ij = R_ik d_k U_j
        RgU = jnp.einsum("cik,ckj->cij", Rfull, g)
        Pfull = -(RgU + jnp.swapaxes(RgU, 1, 2))
        P6 = full_to_symm(Pfull)
        G = jnp.maximum(0.5 * (P6[:, 0] + P6[:, 3] + P6[:, 5]), 0.0)

        # wall handling: G/epsilon overrides as in kEpsilon when
        # epsilonWallFunction is active on epsilon
        wall_fn = _has_wall_fn(eps_f, ("epsilonWallFunction",))
        if wall_fn:
            mask, y1 = _wall_data(mesh)
            sqrtk = jnp.sqrt(k)
            eps_wall = (self.Cmu ** 0.75) * sqrtk ** 3 / (_KAPPA * y1)
            nutw = _wall_face_nut(mesh, nut_f)
            magUp = jnp.linalg.norm(U.data, axis=1) / y1
            G_wall = ((nutw + self.nu) * magUp
                      * (self.Cmu ** 0.25) * sqrtk / (_KAPPA * y1))
            G = jnp.where(mask > 0, G_wall, G)

        # epsilon equation
        deps = self.nu + self.Ceps * k * k / eps
        from ...ops import surface as surface_mod
        deps_slot = slot_mod.interpolate(
            mesh, deps, bv=surface_mod.owner_to_b(mesh, deps))
        ddt_e = (fvm.ddt(mesh, eps_f, eps, rdt) if not steady
                 else fvm.ddt_steady(mesh, eps_f))
        e_eqn = (
            ddt_e
            + _transport_ops(mesh, phi, phi_sl, eps_f, self.div_scheme,
                             slot_mod.to_flat(mesh, deps_slot), deps_slot,
                             self.corrected, self.corr_limit)
            + fvm.Sp(mesh, self.C2 * eps / k, eps_f)
        )
        e_eqn = e_eqn.add_source(self.C1 * G * eps / k, mesh)
        if steady and relax < 1.0:
            e_eqn = e_eqn.relax(mesh, relax, eps)
        if wall_fn:
            e_eqn = e_eqn.set_values(mask, eps_wall, mesh)
        eps_new, perf_e = _solve_transport(mesh, eps_f, e_eqn, controls)
        eps_new = bound_below(eps_new, EPS_MIN)
        diag["epsilon"] = perf_e

        # R equation (6 components, one matrix)
        dR = self.nu + self.Cs * k * k / eps_new
        dR_slot = slot_mod.interpolate(
            mesh, dR, bv=surface_mod.owner_to_b(mesh, dR))
        ddt_R = (fvm.ddt(mesh, R_f, R6, rdt) if not steady
                 else fvm.ddt_steady(mesh, R_f))
        R_eqn = (
            ddt_R
            + _transport_ops(mesh, phi, phi_sl, R_f, self.div_scheme,
                             slot_mod.to_flat(mesh, dR_slot), dR_slot,
                             self.corrected, self.corr_limit)
            + fvm.Sp(mesh, self.Clrr1 * eps_new / k, R_f)
        )
        trP = P6[:, 0] + P6[:, 3] + P6[:, 5]
        devP = P6 - (trP / 3.0)[:, None] * jnp.asarray(
            [1.0, 0.0, 0.0, 1.0, 0.0, 1.0], R6.dtype)[None, :]
        iso = ((2.0 / 3.0) * (self.Clrr1 - 1.0) * eps_new)[:, None] \
            * jnp.asarray([1.0, 0.0, 0.0, 1.0, 0.0, 1.0],
                          R6.dtype)[None, :]
        srcR = P6 + iso - self.Clrr2 * devP
        extra = self._pressure_strain_extra(mesh, tstate, U, R6, P6,
                                            k, eps_new)
        if extra is not None:
            srcR = srcR + extra
        R_eqn = R_eqn.add_source(srcR, mesh)
        if steady and relax < 1.0:
            R_eqn = R_eqn.relax(mesh, relax, R6)
        R_new, perf_R = _solve_transport(mesh, R_f, R_eqn, controls)
        diag["R"] = perf_R

        # realizability floors: positive normal stresses
        diag_idx = jnp.asarray([0, 3, 5])
        R_new = R_new.at[:, diag_idx].set(
            jnp.maximum(R_new[:, diag_idx], K_MIN))
        k_new = jnp.maximum(
            0.5 * (R_new[:, 0] + R_new[:, 3] + R_new[:, 5]), K_MIN)
        nut_new = self.Cmu * k_new * k_new / eps_new
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        new = dict(tstate)
        new.update(R=R_f.with_data(R_new), epsilon=eps_f.with_data(eps_new),
                   k=k_f.with_data(k_new), nut=new_nut)
        return new, diag

    def div_dev_reff(self, mesh, tstate, U: VolField):
        """fvc::div(R) + fvc::laplacian(nut, U) - fvm::laplacian(nuEff, U)
        (reference LRR::divDevReff)."""
        from ...ops import slot as slot_mod

        nut_f: VolField = tstate["nut"]
        nu_slot = self.nu_eff_slot(mesh, tstate)
        mat = -fvm.laplacian(mesh, slot_mod.to_flat(mesh, nu_slot), U,
                             corrected=self.corrected,
                             gamma_dims=dimViscosity,
                             limit=self.corr_limit, gamma_slot=nu_slot)
        div_R = _div_symm_tensor(mesh, tstate["R"].data)
        nut_face = self.nu_eff_face(mesh, tstate) - self.nu
        lap_U = fvc.laplacian(mesh, nut_face, U, corrected=False)
        return mat, div_R + lap_U


class LaunderGibsonRSTM(LRR):
    """Launder-Gibson RSTM with wall-reflection redistribution
    (reference: RAS/LaunderGibsonRSTM/LaunderGibsonRSTM.C). The
    Gibson-Launder (1978) wall terms damp the wall-normal stress using
    the wall distance and wall-normal direction n = grad(y)/|grad(y)|:

        f_w = Cmu^0.75 k^1.5 / (eps kappa y)
        phi_w1 = C1Ref (eps/k) [ (R:nn) I - 3/2 (R.nn + nn.R) ] f_w
        phi_w2 = C2Ref [ (phi2:nn) I - 3/2 (phi2.nn + nn.phi2) ] f_w
        phi2   = -Clrr2 dev(P)."""

    name = "LaunderGibsonRSTM"
    C1Ref = 0.5
    C2Ref = 0.3

    def __init__(self, nu, coeffs=None):
        super().__init__(nu, coeffs)
        c = self.coeffs or {}
        self.C1Ref = float(c.get("C1Ref", self.C1Ref))
        self.C2Ref = float(c.get("C2Ref", self.C2Ref))
        self.y_wall = None

    def init_wall_distance(self, poly_mesh, dtype):
        from ...mesh.walldist import wall_distance

        y = wall_distance(poly_mesh)
        y = np.where(np.isfinite(y), y, 1e10)
        self.y_wall = jnp.asarray(np.maximum(y, 1e-10).astype(dtype))

    def _pressure_strain_extra(self, mesh, tstate, U, R6, P6, k, eps):
        # wall-normal from the wall-distance gradient (cheap Gauss grad
        # of a precomputed field; n points away from the wall)
        gy = fvc.grad_component(mesh, self.y_wall,
                                self.y_wall[mesh.ab_owner])
        n = gy / jnp.maximum(
            jnp.linalg.norm(gy, axis=1, keepdims=True), 1e-12)
        fw = (self.Cmu ** 0.75) * k ** 1.5 \
            / (jnp.maximum(eps, EPS_MIN) * _KAPPA * self.y_wall)
        fw = jnp.minimum(fw, 100.0)

        def reflect(S6, coef):
            S = symm_to_full(S6)
            Snn = jnp.einsum("ci,cij,cj->c", n, S, n)    # S : nn
            Sn = jnp.einsum("cij,cj->ci", S, n)          # S . n
            nnT = jnp.einsum("ci,cj->cij", n, n)
            eye = jnp.eye(3, dtype=S.dtype)[None, :, :]
            term = (Snn[:, None, None] * eye
                    - 1.5 * (jnp.einsum("ci,cj->cij", Sn, n)
                             + jnp.einsum("ci,cj->cij", n, Sn)))
            return coef * full_to_symm(term) * fw[:, None]

        phi1 = reflect(R6, self.C1Ref) * (eps / k)[:, None]
        trP = P6[:, 0] + P6[:, 3] + P6[:, 5]
        devP = P6 - (trP / 3.0)[:, None] * jnp.asarray(
            [1.0, 0.0, 0.0, 1.0, 0.0, 1.0], R6.dtype)[None, :]
        phi2 = reflect(-self.Clrr2 * devP, self.C2Ref)
        return phi1 + phi2


class KOmegaSSTSAS(KOmegaSST):
    """Scale-adaptive SST (reference: RAS/kOmegaSSTSAS/kOmegaSSTSAS.C,
    Menter-Egorov). Adds the QSAS source to the omega equation:

        L    = sqrt(k) / (Cmu^0.25 omega)
        LvK  = max(kappa |S| / |lap U|, Cs sqrt(kappa zeta2 /
                   (beta/Cmu - gamma)) * delta)
        QSAS = max(zeta2 kappa S2 (L/LvK)^2
                   - C 2k/sigmaPhi max(|grad w|^2/w^2, |grad k|^2/k^2), 0)."""

    name = "kOmegaSSTSAS"
    zetaTilde2 = 3.51
    sigmaPhi = 2.0 / 3.0
    Csas = 0.262
    C_ = 2.0

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        k_f, w_f = tstate["k"], tstate["omega"]
        k = jnp.maximum(k_f.data, K_MIN)
        omega = jnp.maximum(w_f.data, OMEGA_MIN)
        nut = tstate["nut"].data

        _, S2 = production(mesh, nut, U)
        S2 = jnp.maximum(S2, 1e-20)
        # |lap U| via the explicit unit-diffusivity vector laplacian
        ones_f = jnp.ones((mesh.n_faces,), k.dtype)
        lapU = fvc.laplacian(mesh, ones_f, U, corrected=False)
        mag_lapU = jnp.maximum(jnp.linalg.norm(lapU, axis=1), 1e-20)

        L = jnp.sqrt(k) / ((_CMU ** 0.25) * omega)
        delta = jnp.cbrt(mesh.v)
        # high-wavenumber floor on the von Karman length scale
        lvk_floor = self.Csas * jnp.sqrt(
            _KAPPA * self.zetaTilde2
            / (self.beta1 / _CMU - self.gamma1)) * delta
        LvK = jnp.maximum(_KAPPA * jnp.sqrt(S2) / mag_lapU, lvk_floor)

        gk = fvc.grad(mesh, k_f)
        gw = fvc.grad(mesh, w_f)
        grad_term = jnp.maximum(
            jnp.sum(gw * gw, axis=1) / (omega * omega),
            jnp.sum(gk * gk, axis=1) / (k * k))
        qsas = jnp.maximum(
            self.zetaTilde2 * _KAPPA * S2 * (L / LvK) ** 2
            - self.C_ * 2.0 * k / self.sigmaPhi * grad_term, 0.0)
        return super().correct(mesh, tstate, U, phi, dt, steady, relax,
                               controls, phi_slot=phi_slot,
                               extra_omega_src=qsas)


register("LamBremhorstKE", LamBremhorstKE)
register("qZeta", QZeta)
register("v2f", V2F)
register("LRR", LRR)
register("LaunderGibsonRSTM", LaunderGibsonRSTM)
register("kOmegaSSTSAS", KOmegaSSTSAS)
