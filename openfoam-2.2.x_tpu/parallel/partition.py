"""Mesh partitioning (decomposePar equivalent).

Reference: src/parallel/decompose/ — decompositionMethod with
simple/hierarchical/scotch backends. On an accelerator there are no processor
directories: partitioning is a host-side cell REORDERING so each chip's
contiguous block of the global arrays is spatially compact, then GSPMD
shards the cell dimension (parallel/gspmd.py). Geometric recursive
coordinate bisection ~= the reference's `simple`/`hierarchical`
methods; scotch-quality graph partitioning can be slotted in later
without changing any caller."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def decompose_simple(mesh, n_xyz, order: str = "xyz") -> np.ndarray:
    """`simple`/`hierarchical` geometric decomposition (reference:
    simpleGeomDecomp/hierarchGeomDecomp): split the domain into
    nx*ny*nz equal-count slabs, axis by axis in the given order."""
    c = np.asarray(mesh.c)
    n_cells = c.shape[0]
    parts = np.zeros(n_cells, dtype=np.int64)
    ax_of = {"x": 0, "y": 1, "z": 2}
    stride = 1
    for ch in order:
        ax = ax_of[ch]
        n = int(n_xyz[ax])
        if n <= 1:
            continue
        # within each existing part, split along this axis into n
        new_parts = parts * n
        for p in np.unique(parts):
            idx = np.where(parts == p)[0]
            ordr = idx[np.argsort(c[idx, ax], kind="stable")]
            chunks = np.array_split(ordr, n)
            for i, ch_idx in enumerate(chunks):
                new_parts[ch_idx] = p * n + i
        parts = new_parts
    # compact part ids
    _, parts = np.unique(parts, return_inverse=True)
    return parts.astype(np.int64)


def decompose_manual(mesh, data_file: str) -> np.ndarray:
    """`manual` decomposition (reference: manualDecomp): cellToProc
    list from a file (one int per cell, or a FoamFile labelList)."""
    txt = open(data_file).read()
    import re as _re

    nums = _re.findall(r"-?\d+", txt.split("(")[-1].split(")")[0]
                       if "(" in txt else txt)
    arr = np.asarray([int(x) for x in nums], dtype=np.int64)
    if arr.shape[0] != mesh.n_cells:
        raise ValueError(
            f"manual decomposition: {arr.shape[0]} entries for "
            f"{mesh.n_cells} cells")
    return arr


def decompose(mesh, n_parts: int, method: str = "rcb",
              coeffs=None) -> np.ndarray:
    """cellToProc [nC]. Methods: rcb (default; the reference's
    scotch-quality geometric fallback), simple, hierarchical,
    manual."""
    if method in ("simple", "hierarchical"):
        coeffs = coeffs or {}
        n_xyz = coeffs.get("n", (n_parts, 1, 1))
        if hasattr(n_xyz, "__len__") and len(n_xyz) == 3:
            nx, ny, nz = (int(v) for v in n_xyz)
        else:
            nx, ny, nz = int(n_parts), 1, 1
        order = str(coeffs.get("order", "xyz"))
        return decompose_simple(mesh, (nx, ny, nz), order)
    if method == "manual":
        return decompose_manual(mesh, str(coeffs["dataFile"]))
    return _decompose_rcb(mesh, n_parts)


def _decompose_rcb(mesh, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection -> cellToProc [nC]."""
    c = np.asarray(mesh.c if hasattr(mesh, "c") else mesh.c)
    n_cells = c.shape[0]
    parts = np.zeros(n_cells, dtype=np.int64)

    def split(idx: np.ndarray, lo: int, hi: int) -> None:
        n = hi - lo
        if n <= 1:
            parts[idx] = lo
            return
        ext = c[idx].max(axis=0) - c[idx].min(axis=0)
        axis = int(np.argmax(ext))
        order = idx[np.argsort(c[idx, axis], kind="stable")]
        k = order.shape[0] * (n // 2) // n  # proportional split
        split(order[:k], lo, lo + n // 2)
        split(order[k:], lo + n // 2, hi)

    split(np.arange(n_cells), 0, n_parts)
    return parts


def cut_faces(mesh, parts: np.ndarray) -> int:
    nif = mesh.n_internal_faces
    own = np.asarray(mesh.owner)[:nif]
    nei = np.asarray(mesh.neighbour)
    return int((parts[own] != parts[nei]).sum())


def renumber_for(mesh, n_parts: int) -> np.ndarray:
    """Permutation `perm` (new order of old cell ids) putting each
    partition's cells contiguous — decomposePar as a relabelling."""
    parts = decompose(mesh, n_parts)
    return np.argsort(parts, kind="stable")
