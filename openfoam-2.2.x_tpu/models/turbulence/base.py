"""Turbulence model framework.

Reference: src/turbulenceModels/incompressible/{turbulenceModel,RAS,LES}
— the `turbulenceModel::New` RTS factory, the `divDevReff(U)` momentum
coupling and the per-step `correct()`. Design: a model is a static
config object whose methods are pure jit-traceable functions over
(mesh, tstate, U, phi); its fields (k, epsilon/omega, nut, ...) live in
the solver state pytree under 'turb'.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ...core.dictionary import FoamDict
from ...core.dimensions import dimViscosity
from ...core.fields import VolField
from ...ops import fvc, fvm, surface


def bound_below(x: Any, min_val: float) -> Any:
    """reference: src/finiteVolume/cfdTools/general/bound/bound.C."""
    return jnp.maximum(x, min_val)


class TurbulenceModel:
    """Base: laminar (no-op) model."""

    name = "laminar"
    field_names: Tuple[str, ...] = ()

    def __init__(self, nu: float, coeffs: Optional[FoamDict] = None):
        self.nu = nu
        self.coeffs = coeffs or {}
        # convection scheme for the model's transport equations
        # (reference default: div(phi,k) Gauss upwind/limitedLinear)
        self.div_scheme = "upwind"
        # non-orthogonal deferred correction in the model's laplacians
        # (set from the case's laplacianSchemes at load)
        self.corrected = False
        self.corr_limit = 1.0

    # -- state ----------------------------------------------------------------
    def init_state(self, mesh, case=None) -> Dict[str, VolField]:
        return {}

    # -- coupling ----------------------------------------------------------------
    def nut(self, mesh, tstate) -> Any:
        return jnp.zeros((mesh.n_cells,), mesh.v.dtype)

    def nu_eff_cell(self, mesh, tstate) -> Any:
        return self.nu + self.nut(mesh, tstate)

    def nu_eff_face(self, mesh, tstate) -> Any:
        """nu + nut at faces; wall-function nut BCs contribute through
        the nut field's boundary values."""
        if "nut" in tstate:
            nut_f = fvc.interpolate(mesh, tstate["nut"])
            return self.nu + nut_f
        return jnp.full((mesh.n_faces,), self.nu, mesh.v.dtype)

    def nu_eff_slot(self, mesh, tstate):
        """(SlotFace of nuEff over internal faces, boundary values) —
        the gather-free twin of nu_eff_face (ops/slot.py)."""
        from ...ops import slot as slot_mod

        if "nut" in tstate:
            nut: VolField = tstate["nut"]
            bv = self.nu + nut.boundary_values(mesh)
            f = slot_mod.interpolate(mesh, nut.data, bv=bv)
            return slot_mod.SlotFace(self.nu + f.sv, self.nu + f.fb, bv)
        dt = mesh.v.dtype
        return slot_mod.SlotFace(
            jnp.full(mesh.st_wself.shape, self.nu, dt),
            jnp.full(mesh.fb_wself.shape, self.nu, dt),
            jnp.full((mesh.n_boundary_faces,), self.nu, dt))

    def div_dev_reff(self, mesh, tstate, U: VolField):
        """-laplacian(nuEff, U) - div(nuEff dev(grad(U)^T))
        (reference: incompressible RASModel/LESModel divDevReff).
        Returns (FvMatrix implicit, explicit source [nC,3] per volume)."""
        from ...ops import slot as slot_mod

        nu_slot = self.nu_eff_slot(mesh, tstate)
        nu_eff_f = slot_mod.to_flat(mesh, nu_slot)
        mat = -fvm.laplacian(mesh, nu_eff_f, U, corrected=self.corrected,
                             gamma_dims=dimViscosity,
                             limit=self.corr_limit, gamma_slot=nu_slot)
        g = fvc.grad(mesh, U)  # [nC,3,3], g[i,j] = d_i u_j
        gT = jnp.swapaxes(g, 1, 2)
        tr = jnp.trace(g, axis1=1, axis2=2)
        dev_t = gT - (tr / 3.0)[:, None, None] * jnp.eye(3, dtype=g.dtype)
        nu_eff_c = self.nu_eff_cell(mesh, tstate)
        tau = nu_eff_c[:, None, None] * dev_t
        # div of a tensor: (1/V) sum_f Sf . tau_f -> [nC,3], slot form
        nif = mesh.n_internal_faces
        tau_f = slot_mod.interpolate(mesh, tau.reshape(-1, 9))
        sv = tau_f.sv.reshape(tau_f.sv.shape[:2] + (3, 3))
        flux_sv = jnp.einsum("cmi,cmij->cmj", mesh.st_sf, sv)
        div_tau = jnp.sum(flux_sv * mesh.st_valid[:, :, None], axis=1)
        if mesh.fb_cells.shape[0]:
            fbt = tau_f.fb.reshape(-1, 3, 3)
            flux_fb = jnp.einsum("fi,fij->fj", mesh.fb_sf, fbt)
            div_tau = div_tau.at[mesh.fb_cells].add(flux_fb)
        # compact active-boundary contribution (zero-gradient tau)
        flux_b = jnp.einsum("fi,fij->fj", mesh.ab_sf, tau[mesh.ab_owner])
        div_tau = div_tau.at[mesh.ab_owner].add(flux_b)
        div_tau = div_tau / mesh.v[:, None]
        return mat, -div_tau

    # -- per-step update -------------------------------------------------------
    def correct(self, mesh, tstate, U: VolField, phi, dt,
                steady: bool = False, relax: float = 1.0,
                controls: Optional[Dict] = None,
                phi_slot=None) -> Tuple[Dict, Dict]:
        return tstate, {}


def production(mesh, nut: Any, U: VolField) -> Tuple[Any, Any]:
    """G = nut * 2|symm(grad U)|^2 and S2 = 2|symm|^2; returns (G, S2)."""
    g = fvc.grad(mesh, U)
    s = 0.5 * (g + jnp.swapaxes(g, 1, 2))
    s2 = 2.0 * jnp.sum(s * s, axis=(1, 2))
    return nut * s2, s2


_REGISTRY: Dict[str, Callable] = {}


def register(name: str, cls) -> None:
    _REGISTRY[name] = cls


def select(props: FoamDict, nu: float, kind: str = "RAS",
           compressible: bool = False) -> TurbulenceModel:
    """turbulenceModel::New — dispatch on RASModel/LESModel keyword
    (reference: RASProperties/LESProperties in constant/).

    compressible=True resolves the keyword in the compressible
    namespace first (exactly as the reference's namespace comes from
    which turbulence library the SOLVER links, not from the dict);
    `nu` is then the molecular DYNAMIC viscosity mu. Models without a
    compressible twin fall back to the incompressible form (documented
    alias, flagged by model.compressible_form == False)."""
    from . import (compressible as _comp,  # noqa: F401
                   compressible2 as _comp2, les, les2, les3,
                   les4, ras, ras2, ras3, ras4, ras5)  # ensure registration

    if str(props.get("simulationType", kind)) == "laminar":
        return TurbulenceModel(nu)
    name = str(props.get("RASModel", props.get("LESModel", "laminar")))
    if name == "laminar" or str(props.get("turbulence", "on")) in ("off", "no"):
        return TurbulenceModel(nu)
    if compressible and f"compressible::{name}" in _REGISTRY:
        name = f"compressible::{name}"
    coeffs = props.get(name.split("::")[-1] + "Coeffs", FoamDict())
    if name not in _REGISTRY:
        raise ValueError(f"unknown turbulence model {name!r}; "
                         f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](nu, coeffs)
