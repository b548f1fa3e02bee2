"""Radiation — P1 spherical-harmonics model.

Rebuild of reference: src/thermophysicalModels/radiationModels/
(radiationModel::P1 + constantAbsorptionEmission +
MarshakRadiationFvPatchScalarField). The P1 equation for incident
radiation G [W/m^2]:

    div(Gamma grad G) - a G = -4 e sigma T^4,   Gamma = 1/(3(a+s))

with the Marshak boundary condition (mixed): at a grey wall of
emissivity eps and temperature Tw,

    refValue      = 4 sigma Tw^4
    valueFraction = eps / (2 (2 - eps)) /
                    (eps / (2 (2 - eps)) + Gamma * deltaCoeffs)

The energy-equation coupling (radiationModel::Sh):
    Sh = a G - 4 e sigma T^4     [W/m^3]
"""

from __future__ import annotations

import dataclasses as _dc
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..bc import patchfields as pf
from ..core.dimensions import DimensionSet
from ..core.fields import VolField, vol_scalar
from ..ops import fvm
from ..solvers import linear

SIGMA = 5.670374419e-8   # Stefan-Boltzmann [W/m^2/K^4]


class P1Config(NamedTuple):
    a: float = 0.5            # absorption coefficient [1/m]
    s: float = 0.0            # scattering coefficient [1/m]
    e: float = 0.5            # emission coefficient (= a for grey gas)
    emissivity: float = 1.0   # wall emissivity (Marshak BC)
    g_controls: Dict = None

    @property
    def gamma(self) -> float:
        return 1.0 / (3.0 * (self.a + self.s) + 1e-30)


def make_G(mesh, cfg, T_wall_bcs) -> VolField:
    """Initial G field with Marshak mixed BCs on wall patches (other
    patches zero-gradient). T_wall_bcs: the T field's BCs, used to read
    wall temperatures. For fvDOM G is a derived quantity: plain
    zero-gradient BCs."""
    if isinstance(cfg, FvDOMConfig):
        bcs = [pf.PatchField(kind="empty", vfrac=0.0)
               if p.type == "empty" else pf.zero_gradient()
               for p in mesh.patches]
        return vol_scalar(mesh, 0.0, name="G",
                          dims=DimensionSet.of(1, 0, -3), bcs=tuple(bcs))
    bcs = []
    eps = cfg.emissivity
    marshak_f0 = eps / (2.0 * (2.0 - eps))
    for patch, tb in zip(mesh.patches, T_wall_bcs):
        if patch.type == "empty":
            bcs.append(pf.PatchField(kind="empty", vfrac=0.0))
        elif pf.is_value_bc(tb):
            tw = jnp.asarray(tb.ref_value)
            gw = 4.0 * SIGMA * tw ** 4
            dc = mesh.delta_coeffs[patch.slice]
            frac = marshak_f0 / (marshak_f0 + cfg.gamma * dc)
            bcs.append(pf.mixed(jnp.broadcast_to(gw, (patch.size,)),
                                0.0, frac))
        else:
            bcs.append(pf.zero_gradient())
    G = vol_scalar(mesh, 0.0, name="G",
                   dims=DimensionSet.of(1, 0, -3), bcs=tuple(bcs))
    return G


def solve_G(mesh, G: VolField, T: Any, cfg, T_bcs=None
            ) -> Tuple[VolField, Any]:
    """One implicit P1 solve (reference: P1::calculate) — or, when cfg
    is an FvDOMConfig, the full discrete-ordinates sweep."""
    if isinstance(cfg, FvDOMConfig):
        return solve_fvdom(mesh, G, T, cfg, T_bcs=T_bcs)
    ctl = cfg.g_controls or {"solver": "PCG",
                             "preconditioner": "polynomial",
                             "tolerance": 1e-8, "relTol": 0.01,
                             "maxIter": 2000}
    lap = fvm.laplacian(mesh, jnp.asarray(cfg.gamma, mesh.v.dtype), G,
                        corrected=False,
                        gamma_dims=DimensionSet.of(0, 1, 0))
    # -lap is positive-definite; add the absorption sink a*G and the
    # emission source 4 e sigma T^4
    eqn = (-lap).replace_fields(
        diag=(-lap).diag + mesh.v * cfg.a,
        source=(-lap).source
        + mesh.v * 4.0 * cfg.e * SIGMA * jnp.asarray(T) ** 4)
    data, perf = linear.solve(mesh, eqn, G.data, ctl)
    return G.with_data(jnp.maximum(data, 0.0)), perf


def Sh(mesh, G: VolField, T: Any, cfg) -> Any:
    """Radiative source for the energy equation [W/m^3]
    (reference: radiationModel::Sh = a*G - 4*e*sigma*T^4)."""
    return cfg.a * G.data - 4.0 * cfg.e * SIGMA * jnp.asarray(T) ** 4


# ---------------------------------------------------------------------------
# fvDOM — discrete ordinates
# ---------------------------------------------------------------------------


class FvDOMConfig(NamedTuple):
    """fvDOM discrete-ordinates model (reference: radiationModels/fvDOM/
    fvDOM.C + radiativeIntensityRay.C). The RTE is discretised into
    nTheta * 4*nPhi solid-angle rays, each an upwind advection solve

        div(I_i d_i . Sf) + a V I_i = a V sigma T^4 / pi

    with the greyDiffusiveRadiation wall closure: incoming rays see the
    wall emission eps*sigma*Tw^4/pi (mixed BC, per-face switched on the
    ray-normal sign); outgoing rays leave freely. Design: the ray
    loop unrolls inside one jitted step (each ray is a multi-diagonal
    upwind matrix solved by PBiCGStab); in-scatter is omitted (s only
    attenuates — documented deviation, reference default sigma_s = 0)."""

    a: float = 0.5
    s: float = 0.0
    e: float = 0.5
    emissivity: float = 1.0
    n_theta: int = 2           # polar divisions (0..pi)
    n_phi: int = 2             # azimuthal divisions PER OCTANT (x4 total)
    g_controls: Dict = None


def fvdom_directions(cfg: FvDOMConfig):
    """Ray mid-point directions [nRay,3] and solid-angle weights [nRay]
    (sum = 4 pi). Reference: fvDOM constructor's theta/phi loops."""
    import numpy as np

    nT, nP = cfg.n_theta, 4 * cfg.n_phi
    dth = np.pi / nT
    dph = 2.0 * np.pi / nP
    dirs, wts = [], []
    for i in range(nT):
        th = (i + 0.5) * dth
        for j in range(nP):
            ph = (j + 0.5) * dph
            dirs.append((np.sin(th) * np.cos(ph),
                         np.sin(th) * np.sin(ph),
                         np.cos(th)))
            # exact integral of sin(theta) over the control angle
            wts.append((np.cos(i * dth) - np.cos((i + 1) * dth)) * dph)
    return np.asarray(dirs), np.asarray(wts)


def _ray_field(mesh, d, T_bcs, cfg: FvDOMConfig):
    """Intensity VolField template for ray direction d: mixed wall BC
    (vfrac 1 on incoming faces, 0 on outgoing), zero-gradient elsewhere
    (reference: greyDiffusiveRadiationMixedFvPatchScalarField)."""
    bcs = []
    eps = cfg.emissivity
    for patch, tb in zip(mesh.patches, T_bcs):
        if patch.type == "empty":
            bcs.append(pf.PatchField(kind="empty", vfrac=0.0))
            continue
        sl = patch.slice
        sf = mesh.sf[sl]
        dn = sf @ jnp.asarray(d, mesh.v.dtype)
        incoming = (dn < 0.0).astype(mesh.v.dtype)
        if pf.is_value_bc(tb):
            tw = jnp.broadcast_to(jnp.asarray(tb.ref_value),
                                  (patch.size,))
            iw = eps * SIGMA * tw ** 4 / jnp.pi
            bcs.append(pf.mixed(iw, 0.0, incoming))
        else:
            bcs.append(pf.zero_gradient())
    return vol_scalar(mesh, 0.0, name="I",
                      dims=DimensionSet.of(1, 0, -3), bcs=tuple(bcs))


def solve_fvdom(mesh, G: VolField, T: Any, cfg: FvDOMConfig, T_bcs=None
                ) -> Tuple[VolField, Any]:
    """Solve all rays, return G = sum_i w_i I_i (reference:
    fvDOM::calculate). T_bcs supplies the wall temperatures for the
    greyDiffusive closure (the caller's T-field BCs)."""
    if T_bcs is None:
        raise ValueError("solve_fvdom needs the T field's BCs (T_bcs)")
    from ..ops import slot as slot_mod
    from ..ops import schemes as schemes_mod

    ctl = cfg.g_controls or {"solver": "PBiCGStab",
                             "tolerance": 1e-6, "relTol": 1e-3,
                             "maxIter": 200}
    import numpy as np

    dirs, wts = fvdom_directions(cfg)
    T4 = jnp.asarray(T) ** 4
    emission = cfg.a * SIGMA * T4 / jnp.pi          # [nC] W/m^3/sr
    Gnew = jnp.zeros_like(G.data)
    I0 = jnp.maximum(G.data, 0.0) / (4.0 * jnp.pi)
    perf = None
    for r in range(dirs.shape[0]):
        d = dirs[r]
        If = _ray_field(mesh, d, T_bcs, cfg).with_data(I0)
        phi = mesh.sf @ jnp.asarray(d, mesh.v.dtype)   # d . Sf per face
        phi = phi * mesh.face_active if hasattr(mesh, "face_active") \
            else phi
        phi_slot = slot_mod.from_flat(mesh, phi)
        w_slot = schemes_mod.weights_slot(mesh, phi_slot, "upwind", If)
        eqn = fvm.div(mesh, phi, If, phi_slot=phi_slot,
                      slot_weights=w_slot,
                      phi_dims=DimensionSet.of(0, 3, -1))
        beta = cfg.a + cfg.s
        eqn = eqn.replace_fields(
            diag=eqn.diag + mesh.v * beta,
            source=eqn.source + mesh.v * emission)
        data, perf = linear.solve(mesh, eqn, I0, ctl)
        Gnew = Gnew + wts[r] * jnp.maximum(data, 0.0)
    return G.with_data(Gnew), perf


# ---------------------------------------------------------------------------
# viewFactor: surface-to-surface radiation in a transparent enclosure
# (reference: src/thermophysicalModels/radiation/radiationModels/
#  viewFactor/ + applications/utilities/preProcessing/viewFactorsGen)
# ---------------------------------------------------------------------------


class ViewFactorModel(NamedTuple):
    """Grey diffuse surface-to-surface radiation between the faces of
    the enclosure patches.

    Design: the reference assembles and solves the radiosity
    system with a dense LU on the master rank; here the view-factor
    matrix F [nF,nF] and the radiosity solve are dense device
    matmuls/solves — dense products, no scatters. View factors come from the
    per-face-pair double-area formula
        F_ij = max(cos t_i, 0) max(cos t_j, 0) A_j / (pi r^2)
    normalised so each row sums to the enclosure fraction (the
    reference's viewFactorsGen ray-agreement correction); occlusion by
    intermediate geometry is not ray-tested (documented deviation —
    convex enclosures are exact)."""
    faces: Any          # [nF] flat face ids of the enclosure
    F: Any              # [nF,nF] view factors (row-normalised)
    emissivity: Any     # [nF]
    areas: Any          # [nF]
    owners: Any         # [nF] owner cells


SIGMA_SB = 5.670374419e-8


def make_viewfactor(mesh, patch_names, emissivity=0.9) -> ViewFactorModel:
    """Build the view-factor matrix for the given enclosure patches."""
    fids = []
    for p in mesh.patches:
        if p.name in patch_names or p.type in patch_names:
            fids.extend(range(p.start, p.start + p.size))
    fids = np.asarray(fids, np.int64)
    cf = np.asarray(mesh.cf)[fids]
    sf = np.asarray(mesh.sf)[fids]
    areas = np.linalg.norm(sf, axis=1)
    # boundary Sf points OUT of the domain; the enclosure radiates
    # INWARD — use the inward normal
    n = -sf / np.maximum(areas, 1e-300)[:, None]
    # pairwise geometry (host, f64 — one-time setup)
    r = cf[None, :, :] - cf[:, None, :]            # i -> j
    d2 = np.maximum((r ** 2).sum(axis=2), 1e-300)
    ct_i = np.einsum("ijd,id->ij", r, n) / np.sqrt(d2)
    ct_j = -np.einsum("ijd,jd->ij", r, n) / np.sqrt(d2)
    F = (np.maximum(ct_i, 0.0) * np.maximum(ct_j, 0.0)
         * areas[None, :] / (np.pi * d2))
    np.fill_diagonal(F, 0.0)
    # row-normalise toward sum(F_ij) = 1 for a closed enclosure
    s = F.sum(axis=1)
    F = np.where(s[:, None] > 1e-12, F / np.maximum(s, 1e-300)[:, None],
                 0.0)
    dt = mesh.v.dtype
    eps = np.broadcast_to(np.asarray(emissivity, float),
                          fids.shape).astype(float)
    return ViewFactorModel(
        faces=jnp.asarray(fids), F=jnp.asarray(F, dt),
        emissivity=jnp.asarray(eps, dt),
        areas=jnp.asarray(areas, dt),
        owners=jnp.asarray(np.asarray(mesh.owner)[fids]))


def viewfactor_heat_flux(vf: ViewFactorModel, T_face):
    """Net radiative heat flux INTO each enclosure face [W/m^2]
    (reference: viewFactor::calculate): solve the grey radiosity
    system  J = eps sigma T^4 + (1-eps) F J,  then
    q = eps/(1-eps) (sigma T^4 - J) ... expressed via irradiation
    H = F J:  q_net = eps (H - sigma T^4)."""
    eb = SIGMA_SB * T_face ** 4
    eps = vf.emissivity
    n = eb.shape[0]
    A = jnp.eye(n, dtype=eb.dtype) - (1.0 - eps)[:, None] * vf.F
    J = jnp.linalg.solve(A, eps * eb)
    H = vf.F @ J
    return eps * (H - eb)


def viewfactor_source(mesh, vf: ViewFactorModel, T_cells,
                      T_face=None):
    """Per-cell radiative source [W/m^3] from the enclosure faces,
    deposited into the owner cells (wall-adjacent), using the owner
    cell temperature as the face temperature unless given."""
    Tf = T_cells[vf.owners] if T_face is None else T_face
    q = viewfactor_heat_flux(vf, Tf)             # W/m^2 into the face
    src = jnp.zeros(mesh.n_cells, q.dtype).at[vf.owners].add(
        q * vf.areas)
    return src / mesh.v
