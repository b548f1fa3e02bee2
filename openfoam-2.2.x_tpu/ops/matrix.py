"""FvMatrix: the LDU-addressed implicit FV system as a jnp pytree.

Rebuild of the reference's fvMatrix/lduMatrix pair
(reference: src/finiteVolume/fvMatrices/fvMatrix/fvMatrix.H,
src/OpenFOAM/matrices/lduMatrix/lduMatrix/lduMatrix.H): diagonal,
per-internal-face upper/lower coefficients, source, plus per-boundary-
face coupling coefficients (internalCoeffs -> diag, boundaryCoeffs ->
source).

Row convention (matching the reference's Amul):
    diag_eff[c]*psi[c] + sum_f off(f)*psi[nbr(f)] = source_eff[c]
with off(f) = upper[f] when c owns f, lower[f] otherwise;
    diag_eff = diag + sum_bfaces ic,   source_eff = source + sum_bfaces bc.

For vector equations the matrix is segregated (reference: fvMatrix
solves component-by-component): diag/upper/lower are scalar, source and
boundary coefficients carry one column per component.

The matrix-vector product is gather-based (see ops/surface.py) — the
single hottest kernel in the framework.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.dimensions import DimensionSet, dimless
from . import surface


def _pytree_dataclass(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    meta = [f.name for f in dataclasses.fields(cls) if f.metadata.get("static")]
    data = [n for n in fields if n not in meta]
    return jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)


def _static(**kw):
    return dataclasses.field(metadata={"static": True}, **kw)


def _addn(a, b):
    """None-aware add of optional flat coefficient arrays (None = not
    materialised; an absent operand contributes nothing flat)."""
    if a is None:
        return b
    if b is None:
        return a
    return a + b


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class FvMatrix:
    diag: Any       # [nC]
    # flat LDU off-diagonals. None = "not materialised": the slot form
    # (soff/sfb) carries the coefficients and no flat [nIf] arrays are
    # ever built — this removes the slot->flat extraction gather
    # (ops/slot.py::to_flat) from
    # the hot path. Methods that genuinely need per-face coefficients
    # (flux, off_coeffs) require them and raise otherwise.
    lower: Any      # [nIf] or None
    upper: Any      # [nIf] or None
    source: Any     # [nC] or [nC,C]
    ic: Any         # internalCoeffs  [nBf] or [nBf,C] (adds to diag)
    bc: Any         # boundaryCoeffs  [nBf] or [nBf,C] (adds to source)
    # per-face explicit flux correction [nF] stashed by corrected
    # laplacians (reference: fvMatrix::faceFluxCorrectionPtr_, set by
    # gaussLaplacianScheme::fvmLaplacian, consumed by fvMatrix::flux)
    fcorr: Any = None
    # slot-form off-diagonal coefficients (ops/slot.py): soff [nC,M] is
    # the coefficient multiplying psi[c + d_m] in row c, sfb [nfb] the
    # COO-fallback twin. When present, solvers/H/relax run gather-free
    # (rolls); None falls back to gathering upper/lower through the
    # mesh tables. Assembled elementwise by fvm when the caller supplies
    # slot-form inputs.
    soff: Any = None
    sfb: Any = None
    # cyclicAMI implicit coupling coefficient per boundary face [nBf]
    # (zero off the AMI patches): row(owner(Af)) gains
    # +ami_coef[f] * sum_j w_fj psi[cell_j] in every matvec
    # (reference: cyclicAMIFvPatchField::updateInterfaceMatrix)
    ami_coef: Any = None
    dims: DimensionSet = _static(default=dimless)   # of source (= op * volume)
    symmetric: bool = _static(default=True)

    def replace_fields(self, **kw) -> "FvMatrix":
        return dataclasses.replace(self, **kw)

    # ---- algebra -----------------------------------------------------------
    def __add__(self, other: "FvMatrix") -> "FvMatrix":
        if isinstance(other, FvMatrix):
            d = self.dims + other.dims  # raises on mismatch
            if self.fcorr is None:
                fc = other.fcorr
            elif other.fcorr is None:
                fc = self.fcorr
            else:
                fc = self.fcorr + other.fcorr
            if self.soff is None or other.soff is None:
                so, sf = None, None
            else:
                so = self.soff + other.soff
                sf = self.sfb + other.sfb
            if self.ami_coef is None:
                am = other.ami_coef
            elif other.ami_coef is None:
                am = self.ami_coef
            else:
                am = self.ami_coef + other.ami_coef
            return FvMatrix(
                diag=self.diag + other.diag,
                lower=_addn(self.lower, other.lower),
                upper=_addn(self.upper, other.upper),
                source=self.source + other.source,
                ic=self.ic + other.ic,
                bc=self.bc + other.bc,
                fcorr=fc,
                soff=so,
                sfb=sf,
                ami_coef=am,
                dims=d,
                symmetric=self.symmetric and other.symmetric,
            )
        return NotImplemented

    def __neg__(self) -> "FvMatrix":
        return FvMatrix(
            diag=-self.diag,
            lower=None if self.lower is None else -self.lower,
            upper=None if self.upper is None else -self.upper,
            source=-self.source, ic=-self.ic, bc=-self.bc,
            fcorr=None if self.fcorr is None else -self.fcorr,
            soff=None if self.soff is None else -self.soff,
            sfb=None if self.sfb is None else -self.sfb,
            ami_coef=None if self.ami_coef is None else -self.ami_coef,
            dims=self.dims, symmetric=self.symmetric,
        )

    def __sub__(self, other: "FvMatrix") -> "FvMatrix":
        if isinstance(other, FvMatrix):
            return self + (-other)
        return NotImplemented

    def add_source(self, vol_source: Any, mesh=None) -> "FvMatrix":
        """RHS += V * field  (the `fvm == fvc_field` operator; the
        explicit field is per-volume, reference: fvMatrix operator==)."""
        v = mesh.v
        if vol_source.ndim == 2:
            v = v[:, None]
        return dataclasses.replace(self, source=self.source + v * vol_source)

    # ---- effective system ---------------------------------------------------
    def diag_eff(self, mesh, cmpt: Optional[int] = None) -> Any:
        ic = self.ic
        if ic.ndim == 2:
            ic = ic[:, cmpt] if cmpt is not None else ic
        if ic.ndim == 2:
            return self.diag[:, None] + surface.boundary_sum(mesh, ic)
        return self.diag + surface.boundary_sum(mesh, ic)

    def source_eff(self, mesh, cmpt: Optional[int] = None) -> Any:
        bc = self.bc
        src = self.source
        if bc.ndim == 2 and cmpt is not None:
            bc = bc[:, cmpt]
            src = src[:, cmpt]
        return src + surface.boundary_sum(mesh, bc)

    def off_coeffs(self, mesh) -> Any:
        """Per-cell off-diagonal coefficients [nC,K]: upper where the
        cell owns the face, lower otherwise; zero on boundary/pad."""
        if self.upper is None:
            raise ValueError(
                "flat LDU coefficients were not materialised (slot-only "
                "matrix); use the soff/off_mul path")
        up = self.upper[mesh.cface_i]
        lo = self.lower[mesh.cface_i]
        return jnp.where(mesh.csign > 0, up, lo) * mesh.cnbr_valid

    def ami_mul(self, mesh, psi: Any) -> Any:
        """cyclicAMI off-diagonal product [nC,(C)] (zero without AMI)."""
        if self.ami_coef is None or not getattr(mesh, "has_ami", False):
            return 0.0
        c = self.ami_coef
        if c.ndim == 2:
            c = c[:, 0]
        ce = c[mesh.ami_entry_face] * mesh.ami_entry_w
        src = psi[mesh.ami_entry_cell]
        contrib = ce[:, None] * src if psi.ndim == 2 else ce * src
        acc = jnp.zeros_like(psi)
        return acc.at[mesh.ami_entry_row].add(contrib)

    def amul(self, mesh, psi: Any, diag_eff: Optional[Any] = None) -> Any:
        """A @ psi for a scalar psi [nC] (the hot SpMV)."""
        if diag_eff is None:
            diag_eff = self.diag_eff(mesh)
        return diag_eff * psi + self.off_mul(mesh, psi)

    def row_sum(self, mesh, diag_eff: Optional[Any] = None) -> Any:
        """sumA: diag + sum of off-diagonals per row (for the reference's
        residual normalisation, lduMatrix::sumA)."""
        if diag_eff is None:
            diag_eff = self.diag_eff(mesh)
        if self.soff is not None:
            off_row = jnp.sum(self.soff, axis=1)
            if mesh.fb_cells.shape[0]:
                off_row = off_row.at[mesh.fb_cells].add(self.sfb)
            if off_row.ndim == 1 and diag_eff.ndim == 2:
                off_row = off_row[:, None]
            rs = diag_eff + off_row
        else:
            rs = diag_eff + jnp.sum(self.off_coeffs(mesh), axis=1)
        if self.ami_coef is not None and getattr(mesh, "has_ami", False):
            c = self.ami_coef
            if c.ndim == 2:
                c = c[:, 0]
            ce = c[mesh.ami_entry_face] * mesh.ami_entry_w
            add = jnp.zeros(mesh.n_cells, rs.dtype).at[
                mesh.ami_entry_row].add(ce)
            rs = rs + (add[:, None] if rs.ndim == 2 else add)
        return rs

    # ---- PISO/SIMPLE operator splits ----------------------------------------
    def A(self, mesh) -> Any:
        """Central coefficient / volume as a SCALAR field; for vector
        matrices the boundary coefficients are component-averaged,
        exactly as the reference (fvMatrix::A via D() with
        cmptAv(internalCoeffs))."""
        ic = self.ic if self.ic.ndim == 1 else jnp.mean(self.ic, axis=1)
        d = self.diag + surface.boundary_sum(mesh, ic)
        return d / mesh.v

    def off_mul(self, mesh, psi: Any) -> Any:
        """Off-diagonal product sum_f off(f)*psi[nbr(f)] — slot (roll)
        path when soff is present, gather path otherwise."""
        ami = self.ami_mul(mesh, psi) if self.ami_coef is not None else 0.0
        if self.soff is not None:
            from . import slot as slot_mod

            return slot_mod.off_apply(mesh, self.soff, self.sfb, psi) + ami
        off = self.off_coeffs(mesh)
        if psi.ndim == 2:
            return jnp.sum(off[:, :, None] * psi[mesh.cnbr], axis=1) + ami
        return jnp.sum(off * psi[mesh.cnbr], axis=1) + ami

    def H1(self, mesh) -> Any:
        """H at psi == 1 with no source: -(sum of off-diagonal
        coefficients)/V (reference: fvMatrix::H1, used by the SIMPLEC
        rAtU = 1/(A - H1) consistency correction)."""
        ones = jnp.ones(self.diag.shape[0], mesh.v.dtype)
        return -self.off_mul(mesh, ones) / mesh.v

    def H(self, mesh, psi: Any) -> Any:
        """(source_eff - offdiag*psi + (Dav - Dc)*psi) / V
        (reference: fvMatrix::H) — the correction term keeps
        psi == H()/A() exact at the segregated solution whenever the
        boundary coefficients are component-symmetric."""
        offpsi = self.off_mul(mesh, psi)
        if psi.ndim == 2:
            d_c = surface.boundary_sum(mesh, self.ic)        # [nC,C]
            d_av = jnp.mean(d_c, axis=1, keepdims=True)
            corr = (d_av - d_c) * psi
            return (self.source_eff(mesh) - offpsi + corr) / mesh.v[:, None]
        return (self.source_eff(mesh) - offpsi) / mesh.v

    def flux(self, mesh, psi: Any) -> Any:
        """Consistent face flux of the implicit operator
        (reference: fvMatrix::flux — used as pEqn.flux()).
        Internal faces: upper*psi_nei - lower*psi_own (owner->neighbour
        positive); boundary: ic*psi_c - bc."""
        nif = mesh.n_internal_faces
        f_int = self.upper * psi[mesh.neighbour] - self.lower * psi[mesh.owner[:nif]]
        ic, bc = self.ic, self.bc
        # compact owner extrapolation: ic/bc are zero on empty faces
        f_bnd = ic * surface.owner_to_b(mesh, psi) - bc
        if self.ami_coef is not None and getattr(mesh, "has_ami", False):
            # coupled-face flux gains the interpolated neighbour part
            nbf = mesh.n_faces - nif
            av = jnp.zeros((nbf,), psi.dtype).at[mesh.ami_entry_face].add(
                mesh.ami_entry_w * psi[mesh.ami_entry_cell])
            c = self.ami_coef if self.ami_coef.ndim == 1 \
                else self.ami_coef[:, 0]
            f_bnd = f_bnd + c * av
        out = jnp.concatenate([f_int, f_bnd], axis=0)
        if self.fcorr is not None:
            # non-orthogonal deferred correction is part of the operator
            # flux (reference: flux += *faceFluxCorrectionPtr_)
            out = out + self.fcorr
        return out

    # ---- constraints ---------------------------------------------------------
    def set_reference(self, cell: int, value: float) -> "FvMatrix":
        """Pin the solution level in one cell (reference:
        fvMatrix::setReference — needed when the matrix has a null
        space, e.g. all-Neumann pressure)."""
        d = self.diag[cell]
        return dataclasses.replace(
            self,
            source=self.source.at[cell].add(d * value),
            diag=self.diag.at[cell].add(d),
        )

    def set_values(self, mask: Any, values: Any, mesh=None) -> "FvMatrix":
        """Constrain psi to `values` where mask==1 by exact row
        replacement + column elimination (reference:
        fvMatrix::setValues): the constrained row becomes
        diag*psi = diag*value (scale-preserving — a large penalty
        instead wrecks the f32 Krylov normalisation), its off-diagonals
        are zeroed, and its known value is eliminated from the free
        rows' sources. Used by wall functions to fix near-wall
        epsilon/omega."""
        if mesh is None:
            raise TypeError("set_values now requires the mesh argument")
        nif = mesh.n_internal_faces
        own = mesh.owner[:nif]
        nei = mesh.neighbour
        m_o = mask[own]
        m_n = mask[nei]
        # eliminate constrained neighbours into the free rows' sources
        elim = self.off_mul(mesh, mask * values)
        keep_f = (1.0 - m_o) * (1.0 - m_n)
        so, sf = self.soff, self.sfb
        if so is not None:
            from . import slot as slot_mod

            nbm = slot_mod.nbr_values(mesh, mask)
            keep_s = (1.0 - mask[:, None]) * (1.0 - nbm)
            so = so * keep_s
            if mesh.fb_cells.shape[0]:
                sf = sf * (1.0 - mask[mesh.fb_cells]) * (1.0 - mask[mesh.fb_nbrs])
        # zero boundary coupling on constrained rows (compact: empty
        # faces read keep_b=1, and their ic/bc are zero anyway)
        keep_b = 1.0 - surface.owner_to_b(mesh, mask)
        if self.ic.ndim == 2:
            keep_b = keep_b[:, None]
        src = self.source
        if src.ndim == 2:
            msk = mask[:, None]
            src = jnp.where(msk > 0, self.diag[:, None] * values,
                            src - elim[:, None])
        else:
            src = jnp.where(mask > 0, self.diag * values, src - elim)
        return dataclasses.replace(
            self,
            upper=self.upper * keep_f,
            lower=self.lower * keep_f,
            source=src,
            ic=self.ic * keep_b,
            bc=self.bc * keep_b,
            soff=so,
            sfb=sf,
        )

    def off_abs_sum(self, mesh) -> Any:
        """sum_f |off(f)| per row (slot path when available)."""
        if self.soff is not None:
            s = jnp.sum(jnp.abs(self.soff), axis=1)
            if mesh.fb_cells.shape[0]:
                s = s.at[mesh.fb_cells].add(jnp.abs(self.sfb))
        else:
            s = jnp.sum(jnp.abs(self.off_coeffs(mesh)), axis=1)
        if self.ami_coef is not None and getattr(mesh, "has_ami", False):
            c = self.ami_coef
            if c.ndim == 2:
                c = c[:, 0]
            ce = jnp.abs(c[mesh.ami_entry_face] * mesh.ami_entry_w)
            s = s.at[mesh.ami_entry_row].add(ce)
        return s

    def relax(self, mesh, alpha: float, psi: Any) -> "FvMatrix":
        """Under-relaxation (reference: fvMatrix::relax): add the
        boundary internal coefficients to the diagonal, FORCE it
        positive and diagonally dominant ("assumes that the central
        coefficient is positive and ensures it is" — a convection
        matrix can have locally negative diags, which would make
        rAU = 1/A(U) negative and the pressure operator indefinite),
        divide by alpha, and compensate the source with the current
        solution."""
        sum_off = self.off_abs_sum(mesh)
        ic_min = self.ic if self.ic.ndim == 1 else jnp.min(self.ic, axis=1)
        b_ic = surface.boundary_sum(mesh, ic_min)
        d0 = self.diag
        d_tot = jnp.maximum(jnp.abs(d0 + b_ic), sum_off) / alpha
        d1 = d_tot - b_ic
        dd = d1 - d0
        if psi.ndim == 2:
            src = self.source + dd[:, None] * psi
        else:
            src = self.source + dd * psi
        return dataclasses.replace(self, diag=d1, source=src)

    def residual(self, mesh, psi: Any, cmpt: Optional[int] = None) -> Any:
        d = self.diag_eff(mesh, cmpt)
        b = self.source_eff(mesh, cmpt)
        p = psi if psi.ndim == 1 else psi[:, cmpt]
        return b - self.amul(mesh, p, d)


def zero_matrix(mesh, n_cmpts: int = 1, dims: DimensionSet = dimless) -> FvMatrix:
    dt = mesh.v.dtype
    shape_c = (mesh.n_cells,) if n_cmpts == 1 else (mesh.n_cells, n_cmpts)
    shape_b = (
        (mesh.n_boundary_faces,)
        if n_cmpts == 1
        else (mesh.n_boundary_faces, n_cmpts)
    )
    return FvMatrix(
        diag=jnp.zeros(mesh.n_cells, dt),
        lower=jnp.zeros(mesh.n_internal_faces, dt),
        upper=jnp.zeros(mesh.n_internal_faces, dt),
        source=jnp.zeros(shape_c, dt),
        ic=jnp.zeros(shape_b, dt),
        bc=jnp.zeros(shape_b, dt),
        soff=jnp.zeros((mesh.n_cells, len(mesh.st_deltas)), dt),
        sfb=jnp.zeros((mesh.fb_cells.shape[0],), dt),
        dims=dims,
    )
