"""Geometric (vol/surface) fields as jnp pytrees.

Whole-array equivalent of the reference's GeometricField
(reference: src/OpenFOAM/fields/GeometricFields/GeometricField/):
internal cell values + per-patch boundary conditions + SI dimensions.
The registry (objectRegistry) collapses to plain dicts of fields held in
solver state pytrees; dimensions are static trace-time metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..bc.patchfields import PatchField, evaluate as bc_evaluate
from .dimensions import DimensionSet, dimless


def _pytree_dataclass(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    meta = [f.name for f in dataclasses.fields(cls) if f.metadata.get("static")]
    data = [n for n in fields if n not in meta]
    return jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)


def _static(**kw):
    return dataclasses.field(metadata={"static": True}, **kw)


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class VolField:
    """Cell-centred field: values [nC] (scalar) or [nC, 3] (vector),
    with one PatchField per mesh patch."""

    data: Any                              # jnp [nC] or [nC,3]
    bcs: Tuple[PatchField, ...]            # one per patch, mesh order
    name: str = _static(default="field")
    dims: DimensionSet = _static(default=dimless)

    @property
    def rank(self) -> int:
        return 0 if self.data.ndim == 1 else 1

    def replace(self, **kw) -> "VolField":
        return dataclasses.replace(self, **kw)

    def with_data(self, data) -> "VolField":
        return dataclasses.replace(self, data=data)

    def boundary_values(self, mesh) -> Any:
        """Evaluate all patch face values, concatenated [nBf,(3)]."""
        vals = []
        for p, bc in zip(mesh.patches, self.bcs):
            vals.append(bc_evaluate(bc, mesh, p, self.data))
        return jnp.concatenate(vals, axis=0)

    def correct_boundary_conditions(self, mesh, **ctx) -> "VolField":
        """Re-evaluate derived BC coefficient data (the analogue of
        correctBoundaryConditions; processor halo swaps happen inside
        shard_map in the parallel layer)."""
        from ..bc.patchfields import update as bc_update

        new_bcs = tuple(
            bc_update(bc, mesh, p, self.data, **ctx)
            for p, bc in zip(mesh.patches, self.bcs)
        )
        return dataclasses.replace(self, bcs=new_bcs)


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class SurfaceField:
    """Face field: values [nF] or [nF,3] — covers internal and boundary
    faces in one flat array (the layout choice; the reference splits
    boundary values per patch)."""

    data: Any
    name: str = _static(default="surfaceField")
    dims: DimensionSet = _static(default=dimless)

    def with_data(self, data) -> "SurfaceField":
        return dataclasses.replace(self, data=data)


def vol_scalar(mesh, value, name="field", dims=dimless, bcs=None) -> VolField:
    from ..bc.patchfields import default_bcs, normalize_bcs

    data = jnp.broadcast_to(jnp.asarray(value), (mesh.n_cells,)).astype(
        mesh.v.dtype
    )
    bcs = bcs if bcs is not None else default_bcs(mesh, rank=0)
    return VolField(
        data=data,
        bcs=normalize_bcs(mesh, bcs, rank=0),
        name=name,
        dims=dims,
    )


def vol_vector(mesh, value, name="field", dims=dimless, bcs=None) -> VolField:
    from ..bc.patchfields import default_bcs

    value = jnp.asarray(value)
    if value.ndim <= 1:
        data = jnp.broadcast_to(value, (mesh.n_cells, 3))
    else:
        data = value
    data = data.astype(mesh.v.dtype)
    from ..bc.patchfields import normalize_bcs

    bcs = bcs if bcs is not None else default_bcs(mesh, rank=1)
    return VolField(
        data=data,
        bcs=normalize_bcs(mesh, bcs, rank=1, ncomp=data.shape[1]),
        name=name,
        dims=dims,
    )
