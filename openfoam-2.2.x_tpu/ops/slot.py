"""Slot-form FV primitives — the gather-free hot path.

A PISO step has ~25 flat-face gathers and scatters; each reads through
an index array, and a scatter with repeated indices serialises on its
conflicts. This module re-expresses the two FV motions (cell->face
interpolation, face->cell integration) on the OFFSET-CANONICAL slot
layout already used by the SpMV (mesh/core.py::offset_stencil):

  a face quantity lives at [nC, M] — slot (c, m) holds the value of the
  face between cell c and cell c + d_m (so each internal face is stored
  once per side); the irregular remainder lives in the COO fallback
  [nfb]; boundary faces stay flat [nBf] (small).

Neighbour access c -> c + d_m is jnp.roll — a contiguous shifted read,
zero index traffic. The reference's equivalent locality device is
CuthillMcKee renumbering for cache reuse (reference: src/renumber/);
here the renumbered offsets ARE the addressing.

All functions take raw jnp arrays (not VolField) — the BC layer stays
on the flat boundary path.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import jax.numpy as jnp


def nbr_values(mesh, data: Any) -> Any:
    """[nC(,C)] cell data -> [nC,M(,C)] values at c + d_m (unmasked:
    invalid slots hold rolled garbage — multiply by st_valid downstream)."""
    cols = [jnp.roll(data, -d, axis=0) for d in mesh.st_deltas]
    return jnp.stack(cols, axis=1)


def fb_pair(mesh, data: Any) -> Tuple[Any, Any]:
    """Fallback self/neighbour values ([nfb(,C)], [nfb(,C)])."""
    return data[mesh.fb_cells], data[mesh.fb_nbrs]


class SlotFace(NamedTuple):
    """A face field in slot form: sv [nC,M(,C)], fb [nfb(,C)],
    bv [nBf(,C)] (None where not materialised)."""

    sv: Any
    fb: Any
    bv: Optional[Any] = None


def _vcol(x, like):
    """Broadcast [nC,M] against [nC,M,C] values."""
    return x[..., None] if like.ndim == 3 else x


def interpolate(mesh, data: Any, bv: Optional[Any] = None) -> SlotFace:
    """Linear cell->face interpolation in slot form:
    vf = wself*self + (1-wself)*nbr (reference: surfaceInterpolation
    linear weights; wself is the cell-side weight so both sides of a
    face compute the SAME value)."""
    nb = nbr_values(mesh, data)
    if data.ndim == 2:
        w = mesh.st_wself[:, :, None]
        sv = w * data[:, None, :] + (1.0 - w) * nb
    else:
        w = mesh.st_wself
        sv = w * data[:, None] + (1.0 - w) * nb
    if mesh.fb_cells.shape[0]:
        s, n = fb_pair(mesh, data)
        wf = mesh.fb_wself if data.ndim == 1 else mesh.fb_wself[:, None]
        fb = wf * s + (1.0 - wf) * n
    else:
        fb = jnp.zeros((0,) + data.shape[1:], data.dtype)
    return SlotFace(sv, fb, bv)


def delta(mesh, data: Any) -> SlotFace:
    """nbr - self per slot (for snGrad-style differences)."""
    nb = nbr_values(mesh, data)
    sv = nb - (data[:, None, :] if data.ndim == 2 else data[:, None])
    if mesh.fb_cells.shape[0]:
        s, n = fb_pair(mesh, data)
        fb = n - s
    else:
        fb = jnp.zeros((0,) + data.shape[1:], data.dtype)
    return SlotFace(sv, fb)


def surface_sum(mesh, f: SlotFace) -> Any:
    """sum of OUTWARD-signed face values per cell
    (reference: fvc::surfaceIntegrate * V). The slot values are stored
    unsigned (same on both sides); the cell's orientation sign is
    st_sign/fb_signs. Boundary values (f.bv, flat [nBf]) are added via
    a small scatter."""
    sv = f.sv
    if sv.ndim == 3:
        acc = jnp.sum(sv * (mesh.st_sign * mesh.st_valid)[:, :, None], axis=1)
    else:
        acc = jnp.sum(sv * mesh.st_sign * mesh.st_valid, axis=1)
    if mesh.fb_cells.shape[0]:
        contrib = f.fb * (mesh.fb_signs[:, None] if f.fb.ndim == 2
                          else mesh.fb_signs)
        acc = acc.at[mesh.fb_cells].add(contrib)
    if f.bv is not None:
        acc = acc.at[mesh.ab_owner].add(f.bv[mesh.ab_rel])
    return acc


def weighted_cell_sum(mesh, f: SlotFace, absolute: bool = False) -> Any:
    """sum_f |v_f| (absolute=True) or unsigned sum over each cell's
    internal faces — e.g. the Courant number's sum|phi| per cell.
    NOTE each internal face contributes to BOTH adjacent cells (as in
    the reference's surfaceSum)."""
    sv = jnp.abs(f.sv) if absolute else f.sv
    acc = jnp.sum(sv * mesh.st_valid, axis=1)
    if mesh.fb_cells.shape[0]:
        c = jnp.abs(f.fb) if absolute else f.fb
        acc = acc.at[mesh.fb_cells].add(c)
    if f.bv is not None:
        bva = f.bv[mesh.ab_rel]
        bva = jnp.abs(bva) if absolute else bva
        acc = acc.at[mesh.ab_owner].add(bva)
    return acc


def to_flat_internal(mesh, f: SlotFace) -> Any:
    """Extract the flat [nIf(,C)] internal-face array (one gather —
    used ONCE per step where a flat view is unavoidable: state phi,
    GAMG Galerkin coarsening)."""
    sv = f.sv
    lin = sv.reshape((-1,) + sv.shape[2:])
    out = lin[mesh.ex_own_lin]
    if mesh.ex_fb_faces.shape[0]:
        out = out.at[mesh.ex_fb_faces].set(f.fb[mesh.ex_fb_idx])
    return out


def to_flat(mesh, f: SlotFace) -> Any:
    """Full flat [nF(,C)] face array (internal extraction + boundary)."""
    fi = to_flat_internal(mesh, f)
    if f.bv is None:
        pad = jnp.zeros((mesh.n_boundary_faces,) + fi.shape[1:], fi.dtype)
        return jnp.concatenate([fi, pad], axis=0)
    return jnp.concatenate([fi, f.bv], axis=0)


def from_flat(mesh, face_vals: Any) -> SlotFace:
    """Gather a flat [nF(,C)] face array into slot form (one gather —
    used once per step for the carried flux)."""
    sv = face_vals[mesh.st_cface]
    fb = face_vals[mesh.fb_faces] if mesh.fb_cells.shape[0] else \
        jnp.zeros((0,) + face_vals.shape[1:], face_vals.dtype)
    bv = face_vals[mesh.n_internal_faces:]
    return SlotFace(sv, fb, bv)


def grad(mesh, data: Any, bv: Any) -> Any:
    """Gauss gradient, slot form. scalar [nC] -> [nC,3]; the boundary
    face values bv [nBf] come from the BC layer (flat, small).
    vector [nC,3] -> [nC,3,3] with g[c,i,j] = d(u_j)/d(x_i)."""
    f = interpolate(mesh, data)
    if data.ndim == 1:
        acc = jnp.sum(mesh.st_sf * f.sv[:, :, None], axis=1)
        if mesh.fb_cells.shape[0]:
            acc = acc.at[mesh.fb_cells].add(mesh.fb_sf * f.fb[:, None])
        acc = acc.at[mesh.ab_owner].add(mesh.ab_sf * bv[mesh.ab_rel][:, None])
        return acc / mesh.v[:, None]
    # vector: outer product Sf_i vf_j
    acc = jnp.sum(mesh.st_sf[:, :, :, None] * f.sv[:, :, None, :], axis=1)
    if mesh.fb_cells.shape[0]:
        acc = acc.at[mesh.fb_cells].add(
            mesh.fb_sf[:, :, None] * f.fb[:, None, :])
    acc = acc.at[mesh.ab_owner].add(
        mesh.ab_sf[:, :, None] * bv[mesh.ab_rel][:, None, :])
    return acc / mesh.v[:, None, None]


def flux_of(mesh, vec_data: Any, bv: Optional[Any] = None) -> SlotFace:
    """Face flux Sf . interp(vec) in slot form (owner->neighbour
    oriented face value, identical on both sides). bv = boundary flux
    [nBf] from the BC layer."""
    f = interpolate(mesh, vec_data)
    sv = mesh.st_sign * jnp.sum(mesh.st_sf * f.sv, axis=2)
    if mesh.fb_cells.shape[0]:
        fb = mesh.fb_signs * jnp.sum(mesh.fb_sf * f.fb, axis=1)
    else:
        fb = jnp.zeros((0,), vec_data.dtype)
    return SlotFace(sv, fb, bv)


def laplacian_correction(mesh, gamma_slot: SlotFace, data: Any, bv: Any,
                         limit: float = 1.0) -> Tuple[SlotFace, Any]:
    """Non-orthogonal deferred correction of the Gauss laplacian in slot
    form (reference: correctedSnGrad::correction): returns the per-face
    correction (owner-oriented face value) and its signed cell sum."""
    g = grad(mesh, data, bv)
    gf = interpolate(mesh, g)
    if data.ndim == 1:
        corr_sv = (gamma_slot.sv * mesh.st_magsf
                   * jnp.sum(mesh.st_corr * gf.sv, axis=2))
    else:
        raise NotImplementedError("slot laplacian correction is scalar-only")
    if mesh.fb_cells.shape[0]:
        corr_fb = (gamma_slot.fb * mesh.fb_magsf
                   * jnp.sum(mesh.fb_corr * gf.fb, axis=1))
    else:
        corr_fb = jnp.zeros((0,), data.dtype)
    if limit < 1.0:
        d = delta(mesh, data)
        orth = gamma_slot.sv * mesh.st_magsf * mesh.st_nodc * (
            mesh.st_sign * d.sv)
        cap = (limit / (1.0 - limit)) * jnp.abs(orth)
        corr_sv = jnp.clip(corr_sv, -cap, cap)
        if mesh.fb_cells.shape[0]:
            orth_fb = gamma_slot.fb * mesh.fb_magsf * mesh.fb_nodc * (
                mesh.fb_signs * d.fb)
            cap_fb = (limit / (1.0 - limit)) * jnp.abs(orth_fb)
            corr_fb = jnp.clip(corr_fb, -cap_fb, cap_fb)
    corr = SlotFace(corr_sv, corr_fb)
    return corr, surface_sum(mesh, corr)


def laplacian_flux(mesh, gamma_slot: SlotFace, data: Any, corrected: bool,
                   corr: Optional[SlotFace] = None) -> SlotFace:
    """Internal-face flux of the symmetric laplacian operator
    (reference: fvMatrix::flux for the pressure equation):
    F = coef*(psi_nei - psi_own) (+ deferred correction), as an
    owner-oriented slot face value."""
    dcs = mesh.st_nodc if corrected else mesh.st_dc
    dcf = mesh.fb_nodc if corrected else mesh.fb_dc
    d = delta(mesh, data)
    sv = gamma_slot.sv * mesh.st_magsf * dcs * (mesh.st_sign * d.sv)
    if mesh.fb_cells.shape[0]:
        fb = gamma_slot.fb * mesh.fb_magsf * dcf * (mesh.fb_signs * d.fb)
    else:
        fb = jnp.zeros((0,), data.dtype)
    if corr is not None:
        sv = sv + corr.sv
        fb = fb + corr.fb
    return SlotFace(sv, fb)


def off_apply(mesh, soff: Any, sfb: Any, psi: Any) -> Any:
    """Off-diagonal SpMV from slot coefficients:
    sum_m soff[c,m] * psi[c+d_m] (+ fallback). Matches
    ops/stencil.py::StencilOp.apply_off but with no per-solve gather."""
    vec = psi.ndim == 2
    nb = nbr_values(mesh, psi)
    if vec:
        acc = jnp.sum(soff[:, :, None] * nb, axis=1)
    else:
        acc = jnp.sum(soff * nb, axis=1)
    if mesh.fb_cells.shape[0]:
        pn = psi[mesh.fb_nbrs]
        acc = acc.at[mesh.fb_cells].add(
            sfb[:, None] * pn if vec else sfb * pn)
    return acc
