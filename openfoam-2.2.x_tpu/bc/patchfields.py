"""Boundary conditions (fvPatchFields) in data-driven mixed form.

The reference implements ~90 BC types as a class hierarchy
(reference: src/finiteVolume/fields/fvPatchFields/). Nearly all reduce
to the reference's own `mixed` base: a per-face triple
(refValue, refGrad, valueFraction) with

    faceValue = f*refValue + (1-f)*(psi_c + refGrad/deltaCoeff)

from which ALL matrix coefficients follow:

    vf     = vic*psi_c + vbc          (value coefficients)
    snGrad = dc*(vf - psi_c)
           = gic*psi_c + gbc,  gic = dc*(vic-1), gbc = dc*vbc

so each BC kind only supplies value_coeffs(); gradient coefficients and
evaluation are derived. Derived physics BCs (inletOutlet, totalPressure,
wall functions, ...) become update() rules that recompute the triple
from solver state each step — the whole-array replacement for virtual
updateCoeffs().

All functions are jit-traceable; `kind` is static so dispatch costs
nothing at runtime.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp


def _pytree_dataclass(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    meta = [f.name for f in dataclasses.fields(cls) if f.metadata.get("static")]
    data = [n for n in fields if n not in meta]
    return jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)


def _static(**kw):
    return dataclasses.field(metadata={"static": True}, **kw)


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class PatchField:
    """Per-patch BC state. Arrays are per-face on the patch:
    [n] or [n,3] matching the field rank (or scalars, broadcast)."""

    ref_value: Any = 0.0
    ref_grad: Any = 0.0
    vfrac: Any = 1.0           # valueFraction f in [0,1]
    kind: str = _static(default="calculated")
    # free-form static options (e.g. inletValue source, pressure name)
    opts: Tuple[Tuple[str, Any], ...] = _static(default=())

    def opt(self, key, default=None):
        for k, v in self.opts:
            if k == key:
                return v
        return default

    def replace(self, **kw) -> "PatchField":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------


def _patch_delta(mesh, patch):
    """deltaCoeffs on the patch, shaped for broadcasting."""
    return mesh.delta_coeffs[patch.slice]


def _patch_normals(mesh, patch):
    sl = patch.slice
    return mesh.sf[sl] / jnp.maximum(mesh.mag_sf[sl], 1e-30)[:, None]


def _patch_internal(mesh, patch, data):
    """Internal (owner cell) values at the patch faces."""
    cells = mesh.owner[patch.slice]
    return data[cells]


def _bcast(x, like):
    """Broadcast BC data (possibly python scalar) against face values."""
    x = jnp.asarray(x, dtype=like.dtype)
    if x.ndim == like.ndim and x.shape == like.shape:
        return x
    return jnp.broadcast_to(x, like.shape)


def _col(x, like):
    """Broadcast a per-face scalar [n] against [n,3] values if needed."""
    x = jnp.asarray(x, dtype=like.dtype)
    if like.ndim == 2 and x.ndim == 1:
        return x[:, None]
    return x


# ---------------------------------------------------------------------------
# value_coeffs per kind: (vic, vbc) with vf = vic*psi_c + vbc
# ---------------------------------------------------------------------------


def _vc_mixed(bc, mesh, patch, vi):
    dc = _col(_patch_delta(mesh, patch), vi)
    f = _col(_bcast(bc.vfrac, vi[..., 0] if vi.ndim == 2 else vi), vi)
    rv = _bcast(bc.ref_value, vi)
    rg = _bcast(bc.ref_grad, vi)
    vic = 1.0 - f
    vbc = f * rv + (1.0 - f) * rg / dc
    return vic, vbc


def _vc_fixed_value(bc, mesh, patch, vi):
    rv = _bcast(bc.ref_value, vi)
    return jnp.zeros_like(vi), rv


def _vc_zero_gradient(bc, mesh, patch, vi):
    return jnp.ones_like(vi), jnp.zeros_like(vi)


def _vc_fixed_gradient(bc, mesh, patch, vi):
    dc = _col(_patch_delta(mesh, patch), vi)
    rg = _bcast(bc.ref_grad, vi)
    return jnp.ones_like(vi), rg / dc


def _vc_calculated(bc, mesh, patch, vi):
    rv = _bcast(bc.ref_value, vi)
    return jnp.zeros_like(vi), rv


def ami_values(mesh, internal):
    """cyclicAMI interpolated values on ALL boundary faces [nBf,(C)]:
    sum_j w_ij psi_own(Bj) on AMI faces, zero elsewhere
    (reference: cyclicAMIFvPatchField::patchNeighbourField)."""
    nbf = mesh.n_faces - mesh.n_internal_faces
    src = internal[mesh.ami_entry_cell]
    w = mesh.ami_entry_w
    contrib = (w[:, None] * src) if internal.ndim == 2 else w * src
    out = jnp.zeros((nbf,) + internal.shape[1:], internal.dtype)
    return out.at[mesh.ami_entry_face].add(contrib)


def _ami_patch_values(mesh, patch, internal):
    """AMI-interpolated values for one patch [size,(C)]."""
    nif = mesh.n_internal_faces
    return ami_values(mesh, internal)[patch.start - nif:
                                      patch.start - nif + patch.size]


def _vc_symmetry(bc, mesh, patch, vi):
    if vi.ndim == 1:  # scalar: zero gradient
        return jnp.ones_like(vi), jnp.zeros_like(vi)
    n = _patch_normals(mesh, patch).astype(vi.dtype)
    # exact: vf = vi - n (n.vi); implicit diag part (1 - n_c^2), rest explicit
    vic = 1.0 - n * n
    vf = vi - n * jnp.sum(n * vi, axis=1, keepdims=True)
    vbc = vf - vic * vi
    return vic, vbc


_VALUE_COEFFS: Dict[str, Callable] = {
    "mixed": _vc_mixed,
    "fixedValue": _vc_fixed_value,
    "zeroGradient": _vc_zero_gradient,
    "fixedGradient": _vc_fixed_gradient,
    "calculated": _vc_calculated,
    "empty": _vc_zero_gradient,
    "symmetryPlane": _vc_symmetry,
    "symmetry": _vc_symmetry,
    "slip": _vc_symmetry,
    # wedge: one-cell-thick axisymmetric sector (reference:
    # constraint/wedge/) — for the small wedge angles the reference
    # prescribes (<5 deg), the mirror/rotation transform is the
    # symmetry transform to O(theta^2); scalars are zero-gradient
    "wedge": _vc_symmetry,
    "noSlip": _vc_fixed_value,
    "inletOutlet": _vc_mixed,
    "outletInlet": _vc_mixed,
    "totalPressure": _vc_mixed,
    "pressureInletOutletVelocity": _vc_mixed,
    "flowRateInletVelocity": _vc_fixed_value,
    "surfaceNormalFixedValue": _vc_fixed_value,
    "freestream": _vc_mixed,
    "movingWallVelocity": _vc_fixed_value,
    "turbulentIntensityKineticEnergyInlet": _vc_mixed,
    "turbulentMixingLengthDissipationRateInlet": _vc_mixed,
    "turbulentMixingLengthFrequencyInlet": _vc_mixed,
    # wall functions: value coefficients are fixed-value-like on nut,
    # zero-gradient-like on k; handled via their update() rules.
    "nutkWallFunction": _vc_calculated,
    "nutUWallFunction": _vc_calculated,
    "kqRWallFunction": _vc_zero_gradient,
    # eps/omega wall functions fix the wall-adjacent CELL value (via the
    # matrix constraint in models/turbulence/ras.py); the face itself is
    # flux-free, i.e. zero-gradient
    "epsilonWallFunction": _vc_zero_gradient,
    "omegaWallFunction": _vc_zero_gradient,
    "kLowReWallFunction": _vc_fixed_value,
    # fixedFluxPressure (reference: fvPatchFields/derived/
    # fixedFluxPressure/): a fixedGradient whose gradient the pressure
    # solver sets so the boundary flux matches the velocity BC. Our
    # pEqns carry body-force fluxes explicitly in phiHbyA, so the
    # consistent default gradient is the stored ref_grad (zero unless a
    # solver supplies `snGradP` through the update rule).
    "fixedFluxPressure": _vc_fixed_gradient,
    # waveTransmissive: mixed with a dynamically updated valueFraction
    # (update rule below); behaves like zeroGradient until phi/c/dt
    # context arrives
    "waveTransmissive": _vc_mixed,
    "pressureInletVelocity": _vc_fixed_value,
    "rotatingWallVelocity": _vc_fixed_value,
    # supersonicFreestream (documented simplification: the reference
    # solves oblique-shock relations for attached flow; here inflow
    # fixes the freestream state and outflow extrapolates — the
    # supersonic-outlet limit)
    "supersonicFreestream": _vc_mixed,
    "variableHeightFlowRate": _vc_mixed,
    "pressureDirectedInletVelocity": _vc_fixed_value,
}


def _empty_shape(patch, internal):
    return (patch.size,) + internal.shape[1:]


_JUMP_KINDS = ("fixedJump", "fixedJumpAMI", "fan")


def jump_signed(bc: PatchField, like) -> Any:
    """Signed jump for jumpCyclic-family BCs: the master side sees the
    partner value MINUS the jump, the slave sees it PLUS the jump
    (reference: jumpCyclicFvPatchField::patchNeighbourField, owner
    branch `pnf -= jump`), i.e. psi rises by +jump from master to
    slave — a fan with positive curve blows master -> slave."""
    s = -1.0 if bc.opt("master", True) else 1.0
    return s * _bcast(bc.ref_value, like)


def value_coeffs(bc: PatchField, mesh, patch, internal) -> Tuple[Any, Any]:
    if bc.kind in _JUMP_KINDS:
        # cyclic pair retained as coincident AMI faces; the coupled
        # face value is the AMI blend with the partner's value OFFSET
        # by the jump (reference: fvPatchFields/derived/fixedJump +
        # fan — jumpCyclic on a createBaffles cyclic pair)
        vb = _ami_patch_values(mesh, patch, internal)
        nif = mesh.n_internal_faces
        w = mesh.ami_wown[patch.start - nif:
                          patch.start - nif + patch.size]
        w = w[:, None] if vb.ndim == 2 else w
        vb = vb + jump_signed(bc, vb)
        return jnp.broadcast_to(w, vb.shape), (1.0 - w) * vb
    if bc.kind == "cyclicAMI":
        # explicit coupled face VALUE: distance-weighted blend of the
        # own cell and the AMI-interpolated neighbour cells (reference:
        # cyclicAMIFvPatchField::evaluate); implicit diffusion coupling
        # is carried by the matrix ami_coef + the solver matvec term
        vb = _ami_patch_values(mesh, patch, internal)
        nif = mesh.n_internal_faces
        w = mesh.ami_wown[patch.start - nif:
                          patch.start - nif + patch.size]
        w = w[:, None] if vb.ndim == 2 else w
        return jnp.broadcast_to(w, vb.shape), (1.0 - w) * vb
    if bc.kind == "empty":
        # empty patches carry 2*nC faces on 2D cases and every consumer
        # masks them out (face_active / compact ab_* scatter) — skip the
        # O(nC)-sized owner gather entirely
        z = jnp.zeros(_empty_shape(patch, internal), internal.dtype)
        return z, z
    vi = _patch_internal(mesh, patch, internal)
    vic, vbc = _VALUE_COEFFS[bc.kind](bc, mesh, patch, vi)
    return jnp.broadcast_to(vic, vi.shape), jnp.broadcast_to(vbc, vi.shape)


def grad_coeffs(bc: PatchField, mesh, patch, internal) -> Tuple[Any, Any]:
    if bc.kind == "empty":
        z = jnp.zeros(_empty_shape(patch, internal), internal.dtype)
        return z, z
    if bc.kind in _JUMP_KINDS:
        vi = _patch_internal(mesh, patch, internal)
        vb = _ami_patch_values(mesh, patch, internal)
        vb = vb + jump_signed(bc, vb)
        dc = _col(_patch_delta(mesh, patch), vi)
        return jnp.broadcast_to(-dc, vi.shape), \
            jnp.broadcast_to(dc * vb, vi.shape)
    if bc.kind == "cyclicAMI":
        vi = _patch_internal(mesh, patch, internal)
        vb = _ami_patch_values(mesh, patch, internal)
        dc = _col(_patch_delta(mesh, patch), vi)
        return jnp.broadcast_to(-dc, vi.shape), \
            jnp.broadcast_to(dc * vb, vi.shape)
    vi = _patch_internal(mesh, patch, internal)
    vic, vbc = _VALUE_COEFFS[bc.kind](bc, mesh, patch, vi)
    dc = _col(_patch_delta(mesh, patch), vi)
    return (jnp.broadcast_to(dc * (vic - 1.0), vi.shape),
            jnp.broadcast_to(dc * vbc, vi.shape))


def evaluate(bc: PatchField, mesh, patch, internal) -> Any:
    if bc.kind in _JUMP_KINDS:
        vb = _ami_patch_values(mesh, patch, internal)
        vb = vb + jump_signed(bc, vb)
        vi = _patch_internal(mesh, patch, internal)
        nif = mesh.n_internal_faces
        w = mesh.ami_wown[patch.start - nif:
                          patch.start - nif + patch.size]
        w = w[:, None] if vb.ndim == 2 else w
        return w * vi + (1.0 - w) * vb
    if bc.kind == "cyclicAMI":
        vb = _ami_patch_values(mesh, patch, internal)
        vi = _patch_internal(mesh, patch, internal)
        nif = mesh.n_internal_faces
        w = mesh.ami_wown[patch.start - nif:
                          patch.start - nif + patch.size]
        w = w[:, None] if vb.ndim == 2 else w
        return w * vi + (1.0 - w) * vb
    if bc.kind == "empty":
        # face values on empty patches are never consumed (face_active
        # masks / compact ab_* indexing skip them): zeros, no gather
        return jnp.zeros(_empty_shape(patch, internal), internal.dtype)
    vi = _patch_internal(mesh, patch, internal)
    vic, vbc = _VALUE_COEFFS[bc.kind](bc, mesh, patch, vi)
    return vic * vi + vbc


def is_value_bc(bc: PatchField) -> bool:
    return bc.kind in ("fixedValue", "noSlip", "calculated")


# ---------------------------------------------------------------------------
# update rules for derived BCs (lagged re-evaluation of the mixed triple)
# ---------------------------------------------------------------------------


def _up_inlet_outlet(bc, mesh, patch, internal, *, phi=None, **ctx):
    """zeroGradient on outflow, fixedValue(inletValue) on inflow
    (reference: fvPatchFields/derived/inletOutlet/)."""
    if phi is None:
        return bc
    phib = phi[patch.slice]
    f = jnp.where(phib < 0.0, 1.0, 0.0)
    return bc.replace(vfrac=f)


def _up_outlet_inlet(bc, mesh, patch, internal, *, phi=None, **ctx):
    if phi is None:
        return bc
    phib = phi[patch.slice]
    f = jnp.where(phib > 0.0, 1.0, 0.0)
    return bc.replace(vfrac=f)


def _up_total_pressure(bc, mesh, patch, internal, *, phi=None, U=None,
                       rho_b=None, **ctx):
    """Fixed-value: p = p0 on outflow, p0 - 0.5 (rho) |U|^2 on inflow
    (reference: derived/totalPressure/ — incompressible psi=none form;
    rho_b supplies the density factor for p_rgh-style solvers)."""
    if phi is None or U is None:
        return bc
    phib = phi[patch.slice]
    p0 = bc.opt("p0", 0.0)
    cells = mesh.owner[patch.slice]
    Ub = U[cells]
    magU2 = jnp.sum(Ub * Ub, axis=1)
    if rho_b is not None:
        magU2 = magU2 * rho_b[cells]
    pval = jnp.where(phib > 0.0, p0, p0 - 0.5 * magU2)
    return bc.replace(ref_value=pval, vfrac=jnp.ones_like(pval))


def _up_pressure_io_velocity(bc, mesh, patch, internal, *, phi=None, **ctx):
    """On outflow zeroGradient; on inflow the normal component is set
    from the flux (reference: derived/pressureInletOutletVelocity/)."""
    if phi is None:
        return bc
    phib = phi[patch.slice]
    n = _patch_normals(mesh, patch)
    magSf = mesh.mag_sf[patch.slice]
    Un = (phib / jnp.maximum(magSf, 1e-30))[:, None] * n
    f = jnp.where(phib < 0.0, 1.0, 0.0)
    return bc.replace(ref_value=Un, vfrac=f)


def _up_freestream(bc, mesh, patch, internal, *, phi=None, **ctx):
    return _up_inlet_outlet(bc, mesh, patch, internal, phi=phi, **ctx)


def _up_fan(bc, mesh, patch, internal, *, phi=None, **ctx):
    """fan: pressure jump from the fan curve evaluated at the current
    volumetric flow rate through the pair (reference: derived/fan/ —
    jump = sum_i f_i Q^i with the 2.2 `f` polynomial coefficients).
    Both sides carry the same curve; Q is measured through the MASTER
    side with outflow-positive sign so the pair agrees."""
    if phi is None:
        return bc
    coeffs = bc.opt("fanPoly")
    if coeffs is None:
        return bc
    phib = phi[patch.slice]
    s = 1.0 if bc.opt("master", True) else -1.0
    Q = s * jnp.sum(phib * mesh.face_active[patch.slice])
    jump = jnp.zeros((), phib.dtype)
    for c in coeffs[::-1]:
        jump = jump * Q + c
    like = _patch_internal(mesh, patch, internal)
    return bc.replace(ref_value=jnp.broadcast_to(
        jnp.maximum(jump, 0.0), like.shape))


_UPDATE: Dict[str, Callable] = {
    "fan": _up_fan,
    "inletOutlet": _up_inlet_outlet,
    "outletInlet": _up_outlet_inlet,
    "totalPressure": _up_total_pressure,
    "pressureInletOutletVelocity": _up_pressure_io_velocity,
    "freestream": _up_freestream,
}


def update(bc: PatchField, mesh, patch, internal, **ctx) -> PatchField:
    fn = _UPDATE.get(bc.kind)
    return fn(bc, mesh, patch, internal, **ctx) if fn else bc


def register_update(kind: str, fn: Callable) -> None:
    """Extension point for model libraries (e.g. wall functions)."""
    _UPDATE[kind] = fn


def _up_fixed_flux_pressure(bc, mesh, patch, internal, *, snGradP=None,
                            **ctx):
    """fixedFluxPressure: the solver hands the consistent boundary
    snGrad (reference: updated from the assembled phiHbyA each pEqn);
    without it the stored gradient stands."""
    if snGradP is None:
        return bc
    return bc.replace(ref_grad=snGradP[patch.slice])


def _up_wave_transmissive(bc, mesh, patch, internal, *, phi=None,
                          dt=None, c_sound=None, **ctx):
    """waveTransmissive (reference: fvPatchFields/derived/
    waveTransmissive/ + advective base): the face value follows the
    outgoing characteristic D(psi)/Dt = 0 at speed |Un| + c, relaxed
    toward fieldInf over lInf:
        v_new = (v_old + Co v_c + k v_inf) / (1 + Co + k)
        Co = (|Un| + c) dt deltaCoeff,   k = (|Un| + c) dt / lInf
    stored as the mixed triple (vfrac=1, ref_value=v_new)."""
    if phi is None or dt is None:
        return bc
    sl = patch.slice
    un = jnp.abs(phi[sl]) / jnp.maximum(mesh.mag_sf[sl], 1e-30)
    cs = c_sound[sl] if c_sound is not None else 0.0
    speed = un + cs
    dc = mesh.delta_coeffs[sl]
    co = speed * dt * dc
    l_inf = float(bc.opt("lInf", 0.0) or 0.0)
    v_inf = bc.opt("fieldInf", None)
    k = speed * dt / l_inf if l_inf > 0 and v_inf is not None else 0.0
    vi = _patch_internal(mesh, patch, internal)
    v_old = bc.ref_value
    if vi.ndim == 2 and jnp.ndim(co) == 1:
        co = co[:, None]
        k = k[:, None] if jnp.ndim(k) == 1 else k
    vinf_t = jnp.asarray(v_inf, vi.dtype) if v_inf is not None else 0.0
    v_new = (v_old + co * vi + k * vinf_t) / (1.0 + co + k)
    return bc.replace(ref_value=v_new, vfrac=jnp.ones(patch.size,
                                                      vi.dtype))


def _up_pressure_inlet_velocity(bc, mesh, patch, internal, *, phi=None,
                                **ctx):
    """pressureInletVelocity (reference: fvPatchFields/derived/
    pressureInletVelocity/): the inlet velocity takes the flux's
    normal magnitude, U = n phi/|Sf|."""
    if phi is None:
        return bc
    sl = patch.slice
    n = mesh.sf[sl] / jnp.maximum(mesh.mag_sf[sl], 1e-30)[:, None]
    u = (phi[sl] / jnp.maximum(mesh.mag_sf[sl], 1e-30))[:, None] * n
    return bc.replace(ref_value=u, vfrac=jnp.ones(patch.size,
                                                  internal.dtype))


def _up_variable_height_flow_rate(bc, mesh, patch, internal, **ctx):
    """variableHeightFlowRate (reference: fvPatchFields/derived/
    variableHeightFlowRate/): phase fraction outlet — zeroGradient
    while the adjacent alpha is between the bounds, clamped fixedValue
    outside them."""
    lo = float(bc.opt("lowerBound", 0.0))
    hi = float(bc.opt("upperBound", 1.0))
    vi = _patch_internal(mesh, patch, internal)
    below = vi < lo
    above = vi > hi
    f = jnp.where(below | above, 1.0, 0.0).astype(vi.dtype)
    rv = jnp.where(below, lo, jnp.where(above, hi, vi))
    return bc.replace(ref_value=rv, vfrac=f)


def _up_supersonic_freestream(bc, mesh, patch, internal, *, phi=None,
                              **ctx):
    if phi is None:
        return bc
    f = jnp.where(phi[patch.slice] < 0.0, 1.0, 0.0)
    return bc.replace(vfrac=f.astype(jnp.asarray(internal).dtype))


def _up_pressure_directed_inlet_velocity(bc, mesh, patch, internal, *,
                                         phi=None, **ctx):
    """pressureDirectedInletVelocity (reference: fvPatchFields/derived/
    pressureDirectedInletVelocity/): velocity along the prescribed
    inletDirection d scaled so the face flux matches, U = d phi/(Sf.d)."""
    if phi is None:
        return bc
    d = jnp.asarray(bc.opt("inletDir", (1.0, 0.0, 0.0)),
                    jnp.asarray(internal).dtype)
    d = d / jnp.maximum(jnp.linalg.norm(d), 1e-30)
    sl = patch.slice
    sfd = jnp.maximum(jnp.abs(mesh.sf[sl] @ d), 1e-30) \
        * jnp.sign(mesh.sf[sl] @ d + 1e-300)
    u = (phi[sl] / sfd)[:, None] * d[None, :]
    return bc.replace(ref_value=u, vfrac=jnp.ones(patch.size,
                                                  internal.dtype))


_UPDATE["pressureDirectedInletVelocity"] = \
    _up_pressure_directed_inlet_velocity
_UPDATE["fixedFluxPressure"] = _up_fixed_flux_pressure
_UPDATE["waveTransmissive"] = _up_wave_transmissive
_UPDATE["pressureInletVelocity"] = _up_pressure_inlet_velocity
_UPDATE["variableHeightFlowRate"] = _up_variable_height_flow_rate
_UPDATE["supersonicFreestream"] = _up_supersonic_freestream


def register_value_coeffs(kind: str, fn: Callable) -> None:
    _VALUE_COEFFS[kind] = fn


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def fixed_value(value, **opts) -> PatchField:
    return PatchField(ref_value=value, vfrac=1.0, kind="fixedValue",
                      opts=tuple(opts.items()))


def zero_gradient(**opts) -> PatchField:
    return PatchField(ref_value=0.0, ref_grad=0.0, vfrac=0.0,
                      kind="zeroGradient", opts=tuple(opts.items()))


def fixed_gradient(grad, **opts) -> PatchField:
    return PatchField(ref_grad=grad, vfrac=0.0, kind="fixedGradient",
                      opts=tuple(opts.items()))


def mixed(ref_value, ref_grad, vfrac, **opts) -> PatchField:
    return PatchField(ref_value=ref_value, ref_grad=ref_grad, vfrac=vfrac,
                      kind="mixed", opts=tuple(opts.items()))


def make(kind: str, **kw) -> PatchField:
    opts = {k: v for k, v in kw.items()
            if k not in ("ref_value", "ref_grad", "vfrac")}
    value_kinds = ("fixedValue", "noSlip", "totalPressure", "calculated")
    return PatchField(
        ref_value=kw.get("ref_value", 0.0),
        ref_grad=kw.get("ref_grad", 0.0),
        vfrac=kw.get("vfrac", 1.0 if kind in value_kinds else 0.0),
        kind=kind,
        opts=tuple(opts.items()),
    )


def shift_value_bcs(bcs, delta) -> Tuple[PatchField, ...]:
    """Shift every BC's ref_value by a constant (used to solve pressure
    relative to an operating level in f32: kinds that do not use
    ref_value are unaffected, value-fixing kinds move with the field)."""
    out = []
    for bc in bcs:
        if bc.kind in ("zeroGradient", "fixedGradient", "empty",
                       "symmetry", "symmetryPlane", "wedge", "slip",
                       "cyclicAMI",
                       # ref_value holds a JUMP, not a level
                       "fixedJump", "fixedJumpAMI", "fan"):
            out.append(bc)
        else:
            out.append(bc.replace(ref_value=bc.ref_value + delta))
    return tuple(out)


def normalize_bcs(mesh, bcs, rank: int,
                  ncomp: int = 3) -> Tuple[PatchField, ...]:
    """Broadcast all BC data to per-face shapes so state pytrees keep
    invariant shapes under scan/while carries (derived BC updates
    rewrite ref_value/vfrac per face). ncomp: component count for
    rank-1 fields (3 for vectors, 6 for symmTensors, 9 for tensors)."""
    dt = mesh.v.dtype
    out = []
    for p, bc in zip(mesh.patches, bcs):
        vshape = (p.size,) if rank == 0 else (p.size, ncomp)
        rv = jnp.broadcast_to(jnp.asarray(bc.ref_value, dt), vshape)
        rg = jnp.broadcast_to(jnp.asarray(bc.ref_grad, dt), vshape)
        vf = jnp.asarray(bc.vfrac, dt)
        vf = jnp.broadcast_to(vf, vshape if vf.ndim == rank + 1 else (p.size,))
        out.append(dataclasses.replace(bc, ref_value=rv, ref_grad=rg, vfrac=vf))
    return tuple(out)


def default_bcs(mesh, rank: int) -> Tuple[PatchField, ...]:
    """zeroGradient everywhere except constraint patches get their type."""
    out = []
    for p in mesh.patches:
        if p.type == "empty":
            out.append(PatchField(kind="empty", vfrac=0.0))
        elif p.type in ("symmetryPlane", "symmetry", "wedge",
                        "cyclicAMI"):
            out.append(PatchField(kind=p.type, vfrac=0.0))
        else:
            out.append(zero_gradient())
    return tuple(out)
