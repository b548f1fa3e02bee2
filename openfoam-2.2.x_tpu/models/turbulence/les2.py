"""Dynamic and scale-similarity LES subgrid models.

Reference: src/turbulenceModels/incompressible/LES/
  - homogeneousDynSmagorinsky/  (volume-averaged Germano-Lilly)
  - dynOneEqEddy/               (k-equation SGS with dynamic Ck)
  - scaleSimilarity/            (Bardina resolved-stress model)
  - mixedSmagorinsky/           (scaleSimilarity + Smagorinsky)
plus the simpleFilter (src/turbulenceModels/LES/LESfilters/
simpleFilter/) used as the test filter.

Design notes: the test filter is the face-area-weighted neighbour average
assembled on the slot tables (gather-free on the structured interior);
the Germano contractions are pure elementwise work, and the
homogeneous (volume-averaged) coefficient needs one global reduction —
a psum under GSPMD sharding.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp

from ...core.fields import VolField
from ...ops import fvc
from .base import TurbulenceModel, production, register
from .les import OneEqEddy, Smagorinsky

K_MIN = 1e-10


def simple_filter(mesh, data: Any) -> Any:
    """Test filter: surfaceSum(|Sf| interp(phi)) / surfaceSum(|Sf|)
    (reference: LESfilters/simpleFilter). data [nC] or [nC,k]."""
    from ...ops import slot as slot_mod

    vec = data.ndim == 2
    f = slot_mod.interpolate(mesh, data)
    w_sv = jnp.linalg.norm(mesh.st_sf, axis=2) * mesh.st_valid  # [nC,M]
    if vec:
        num = jnp.sum(w_sv[:, :, None] * f.sv, axis=1)
    else:
        num = jnp.sum(w_sv * f.sv, axis=1)
    den = jnp.sum(w_sv, axis=1)
    if mesh.fb_cells.shape[0]:
        w_fb = jnp.linalg.norm(mesh.fb_sf, axis=1)
        contrib = w_fb[:, None] * f.fb if vec else w_fb * f.fb
        num = num.at[mesh.fb_cells].add(contrib)
        den = den.at[mesh.fb_cells].add(w_fb)
    # boundary: owner-cell value (zero-gradient extrapolation)
    w_b = jnp.linalg.norm(mesh.ab_sf, axis=1)
    bvals = data[mesh.ab_owner]
    num = num.at[mesh.ab_owner].add(
        w_b[:, None] * bvals if vec else w_b * bvals)
    den = den.at[mesh.ab_owner].add(w_b)
    den = jnp.maximum(den, 1e-30)
    return num / (den[:, None] if vec else den)


def _filter_tensor(mesh, T: Any) -> Any:
    """simple_filter over the trailing tensor axes ([nC,3,3] or
    [nC,6])."""
    shape = T.shape
    flat = T.reshape(shape[0], -1)
    return simple_filter(mesh, flat).reshape(shape)


def _vavg(mesh, x: Any) -> Any:
    """Volume-weighted global average (psum under sharding)."""
    return jnp.sum(x * mesh.v) / jnp.sum(mesh.v)


def _sym_grad(mesh, U: VolField) -> Any:
    g = fvc.grad(mesh, U)
    return 0.5 * (g + jnp.swapaxes(g, 1, 2))   # [nC,3,3]


def _dev(T: Any) -> Any:
    tr = jnp.trace(T, axis1=1, axis2=2)
    return T - (tr / 3.0)[:, None, None] * jnp.eye(3, dtype=T.dtype)


class HomogeneousDynSmagorinsky(Smagorinsky):
    """Dynamic Smagorinsky with volume-averaged (homogeneous) Germano
    coefficients (reference: LES/homogeneousDynSmagorinsky/):

        L  = dev(filt(U U) - filt(U) filt(U))
        M  = delta^2 (4 |filt(S)| filt(S) - filt(|S| S))
        cD = <L:M> / <M:M>          (volume averages)
        nuSgs = cD delta^2 |S|
        KK = 0.5 (filt(|U|^2) - |filt(U)|^2)
        mm = delta^2 (4 |filt(S)|^2 - filt(|S|^2))
        cI = <KK mm> / <mm mm>,  k_sgs = cI delta^2 |S|^2."""

    name = "homogeneousDynSmagorinsky"
    field_names = ("nut",)

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        nut_f: VolField = tstate["nut"]
        delta2 = jnp.cbrt(mesh.v) ** 2
        S = _sym_grad(mesh, U)                       # [nC,3,3]
        magS = jnp.sqrt(2.0 * jnp.sum(S * S, axis=(1, 2)))

        Uf = simple_filter(mesh, U.data)             # [nC,3]
        UU = jnp.einsum("ci,cj->cij", U.data, U.data)
        L = _dev(_filter_tensor(mesh, UU)
                 - jnp.einsum("ci,cj->cij", Uf, Uf))
        Sf = _filter_tensor(mesh, S)
        magSf = jnp.sqrt(2.0 * jnp.sum(Sf * Sf, axis=(1, 2)))
        M = delta2[:, None, None] * (
            4.0 * magSf[:, None, None] * Sf
            - _filter_tensor(mesh, magS[:, None, None] * S))
        cD = _vavg(mesh, jnp.sum(L * M, axis=(1, 2))) / jnp.maximum(
            _vavg(mesh, jnp.sum(M * M, axis=(1, 2))), 1e-30)
        cD = jnp.clip(cD, 0.0, 0.5)                  # stability clip
        nut_new = cD * delta2 * magS
        new_nut = nut_f.with_data(nut_new).correct_boundary_conditions(
            mesh, nu=self.nu, U=U.data)
        new = dict(tstate)
        new["nut"] = new_nut
        return new, {}


class DynOneEqEddy(OneEqEddy):
    """One-equation SGS with dynamically computed Ck (reference:
    LES/dynOneEqEddy/): Ck from the Germano identity on the resolved
    stress, volume-averaged,

        L  = dev(filt(U U) - filt(U) filt(U))
        M  = delta (filt(sqrt(k) S) - 2 sqrt(filt(k)+KK) filt(S))
        Ck = -<L:M>/(2 <M:M>)  [sign: nuSgs closes -2 Ck delta sqrt(k) S]

    Ce stays at its equilibrium value (documented deviation: the
    reference also computes Ce dynamically)."""

    name = "dynOneEqEddy"

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
        ck = -_vavg(mesh, jnp.sum(L * M, axis=(1, 2))) / jnp.maximum(
            2.0 * _vavg(mesh, jnp.sum(M * M, axis=(1, 2))), 1e-30)
        ck = jnp.clip(ck, 0.02, 0.3)
        # run the k-equation with the dynamic Ck (static attr is jit
        # config — pass through a shallow copy is not traceable, so we
        # scale nut after the parent update instead)
        new, diag = super().correct(mesh, tstate, U, phi, dt, steady,
                                    relax, controls, phi_slot=phi_slot)
        k_new = jnp.maximum(new["k"].data, K_MIN)
        nut_new = ck * delta * jnp.sqrt(k_new)
        new["nut"] = new["nut"].with_data(
            nut_new).correct_boundary_conditions(
            mesh, k=k_new, nu=self.nu, U=U.data)
        return new, diag


class ScaleSimilarity(TurbulenceModel):
    """Bardina scale-similarity model (reference:
    LES/scaleSimilarity/): B = filt(U U) - filt(U) filt(U); no eddy
    viscosity — the SGS stress divergence enters the momentum equation
    explicitly."""

    name = "scaleSimilarity"
    field_names = ("nut",)      # carried (zero) for solver uniformity

    def nut(self, mesh, tstate):
        return jnp.zeros((mesh.n_cells,), mesh.v.dtype)

    def _B(self, mesh, U: VolField) -> Any:
        Uf = simple_filter(mesh, U.data)
        UU = jnp.einsum("ci,cj->cij", U.data, U.data)
        return _filter_tensor(mesh, UU) - jnp.einsum(
            "ci,cj->cij", Uf, Uf)

    def div_dev_reff(self, mesh, tstate, U: VolField):
        from ...core.dimensions import dimViscosity
        from ...ops import fvm
        from ...ops import slot as slot_mod
        from .ras2 import _div_symm_tensor, full_to_symm

        # molecular part implicit; dev(B) divergence explicit
        mat = -fvm.laplacian(mesh, jnp.asarray(self.nu, mesh.v.dtype),
                             U, corrected=self.corrected,
                             gamma_dims=dimViscosity,
                             limit=self.corr_limit)
        B = _dev(self._B(mesh, U))
        divB = _div_symm_tensor(mesh, full_to_symm(B))
        return mat, divB

    def correct(self, mesh, tstate, U, phi, dt, steady=False, relax=1.0,
                controls=None, phi_slot=None):
        nut_f = tstate["nut"]
        new = dict(tstate)
        new["nut"] = nut_f.with_data(jnp.zeros_like(nut_f.data))
        return new, {}


class MixedSmagorinsky(Smagorinsky):
    """scaleSimilarity + Smagorinsky (reference:
    LES/mixedSmagorinsky/): the linear combination of the
    scale-similarity stress (explicit) and the Smagorinsky eddy
    viscosity (implicit)."""

    name = "mixedSmagorinsky"
    field_names = ("nut",)

    def div_dev_reff(self, mesh, tstate, U: VolField):
        from .ras2 import _div_symm_tensor, full_to_symm

        mat, src = super().div_dev_reff(mesh, tstate, U)
        Uf = simple_filter(mesh, U.data)
        UU = jnp.einsum("ci,cj->cij", U.data, U.data)
        B = _dev(_filter_tensor(mesh, UU)
                 - jnp.einsum("ci,cj->cij", Uf, Uf))
        divB = _div_symm_tensor(mesh, full_to_symm(B))
        return mat, src + divB


register("homogeneousDynSmagorinsky", HomogeneousDynSmagorinsky)
register("dynOneEqEddy", DynOneEqEddy)
register("scaleSimilarity", ScaleSimilarity)
register("mixedSmagorinsky", MixedSmagorinsky)
