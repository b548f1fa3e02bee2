"""Roll-based stencil SpMV — the hot kernel of every linear solve.

Built on the offset-canonical tables (mesh/core.py::offset_stencil):
the matrix-vector product

    Apsi[c] = diag[c]*psi[c] + sum_m off[c,m] * psi[c + d_m]  (+ fallback)

uses jnp.roll for the constant offsets d_m and a small COO gather/
scatter for the unstructured remainder. XLA fuses the shifted reads,
the coefficient multiply-adds and the diagonal into one elementwise
pass over diag, psi, off and the result.

`off` is materialised once per solve (outside the Krylov while_loop)
from the LDU upper/lower arrays; each solver iteration is then
gather-free.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax.numpy as jnp


class StencilOp(NamedTuple):
    deltas: Tuple[int, ...]
    off: Any          # [nC, M] off-diagonal coeffs in offset-slot order
    fb_cells: Any     # COO fallback
    fb_nbrs: Any
    fb_coeffs: Any

    def apply_off(self, psi: Any) -> Any:
        """offdiag @ psi (no diagonal)."""
        vec = psi.ndim == 2
        acc = jnp.zeros_like(psi)
        for m, d in enumerate(self.deltas):
            coeff = self.off[:, m]
            shifted = jnp.roll(psi, -d, axis=0)
            acc = acc + (coeff[:, None] if vec else coeff) * shifted
        if self.fb_cells.shape[0]:
            contrib = self.fb_coeffs[:, None] * psi[self.fb_nbrs] if vec \
                else self.fb_coeffs * psi[self.fb_nbrs]
            acc = acc.at[self.fb_cells].add(contrib)
        return acc

    def matvec(self, diag: Any, psi: Any) -> Any:
        """diag*psi + offdiag@psi — the hot motion of every Krylov/
        smoother iteration (reference: lduMatrix::Amul,
        src/OpenFOAM/matrices/lduMatrix/)."""
        return diag * psi + self.apply_off(psi)


def from_tables(deltas, st_cface, st_sign, st_valid,
                fb_cells, fb_faces, fb_signs, fb_nbrs,
                upper: Any, lower: Any) -> StencilOp:
    """Materialise per-offset coefficients from LDU upper/lower.
    Row convention (ops/matrix.py): rows where the cell owns the face
    use `upper`, else `lower`."""
    up = upper[st_cface]
    lo = lower[st_cface]
    off = jnp.where(st_sign > 0, up, lo) * st_valid
    if fb_cells.shape[0]:
        fb_coeffs = jnp.where(fb_signs > 0, upper[fb_faces], lower[fb_faces])
    else:
        fb_coeffs = jnp.zeros((0,), off.dtype)
    return StencilOp(tuple(deltas), off, fb_cells, fb_nbrs, fb_coeffs)


def mesh_stencil(mesh, upper: Any, lower: Any) -> StencilOp:
    return from_tables(
        mesh.st_deltas, mesh.st_cface, mesh.st_sign, mesh.st_valid,
        mesh.fb_cells, mesh.fb_faces, mesh.fb_signs, mesh.fb_nbrs,
        upper, lower,
    )
