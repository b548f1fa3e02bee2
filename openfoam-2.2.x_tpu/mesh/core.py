"""Unstructured finite-volume mesh: topology, geometry, device tables.

The reference's central data structure is the face-addressed unstructured
mesh: flat owner/neighbour arrays over faces, with boundary patches as
contiguous face ranges (reference: src/OpenFOAM/meshes/primitiveMesh/,
src/finiteVolume/fvMesh/). This module rebuilds it accelerator-first:

- Host side (`PolyMesh`): NumPy f64 topology + geometry derived with the
  reference's exact algorithms (face-centre/area via fan triangulation,
  cell-centre/volume via pyramid decomposition — reference:
  src/OpenFOAM/meshes/primitiveMesh/primitiveMeshFaceCentresAndAreas.C,
  primitiveMeshCellCentresAndVols.C), plus surface-interpolation data
  (weights, deltaCoeffs, non-orthogonality correction — reference:
  src/finiteVolume/interpolation/surfaceInterpolation/surfaceInterpolation.C).

- Device side (`FvMesh`): a jnp pytree of flat arrays PLUS per-cell
  gather tables (cell->face, cell->neighbour-cell, padded to the max
  face count). Every FV operator then reduces to dense gathers +
  small-axis sums — no scatters on the hot path (a scatter-add with
  repeated indices serialises on its conflicts; a gather does not).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.precision import label_np, scalar_np

# ---------------------------------------------------------------------------
# Patches
# ---------------------------------------------------------------------------

# Geometric/constraint patch types understood by the framework
# (reference: src/OpenFOAM/meshes/polyMesh/polyPatches/).
PATCH_TYPES = (
    "patch",
    "wall",
    "empty",
    "symmetryPlane",
    "symmetry",
    "cyclic",
    "wedge",
    "processor",
    "mappedWall",
    "cyclicAMI",
)


@dataclasses.dataclass(frozen=True)
class Patch:
    """A boundary patch = contiguous face range [start, start+size)."""

    name: str
    type: str
    start: int
    size: int
    # for cyclic/cyclicAMI patches: name of the coupled partner
    neighbour_patch: Optional[str] = None
    # static extras (cyclicAMI transform etc.) as hashable pairs
    attrs: Tuple[Tuple[str, str], ...] = ()

    def attr(self, key: str, default=None):
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    @property
    def slice(self) -> slice:
        return slice(self.start, self.start + self.size)


# ---------------------------------------------------------------------------
# Geometry kernels (host, NumPy f64)
# ---------------------------------------------------------------------------


def face_centres_areas(
    points: np.ndarray, face_pts: np.ndarray, face_npts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Face centres and area vectors by fan triangulation about the
    point-average centre (the reference's algorithm, exact for planar
    and consistent for warped faces). Large meshes route through the
    native accelerator (native/foamtpu_io.cpp::face_geometry, same
    formula) when it is available."""
    n_faces, max_pts = face_pts.shape
    if n_faces > 20000:
        from ..io import native as native_io

        nat = native_io.face_geometry(points, face_pts, face_npts)
        if nat is not None:
            return nat
    idx = np.arange(max_pts)
    valid = idx[None, :] < face_npts[:, None]  # [nF, maxPts]
    fpts = np.clip(face_pts, 0, None)
    fp = np.where(valid[:, :, None], points[fpts], 0.0)
    c_est = fp.sum(axis=1) / face_npts[:, None]

    nxt = (idx[None, :] + 1) % np.maximum(face_npts[:, None], 1)
    p_i = np.where(valid[:, :, None], points[fpts], 0.0)
    p_n = np.where(valid[:, :, None], points[np.take_along_axis(fpts, nxt, axis=1)], 0.0)

    tri_n = np.cross(p_n - p_i, c_est[:, None, :] - p_i)  # 2x triangle normal
    tri_a = np.linalg.norm(tri_n, axis=2)
    tri_c = p_i + p_n + c_est[:, None, :]  # 3x triangle centroid
    tri_n = np.where(valid[:, :, None], tri_n, 0.0)
    tri_a = np.where(valid, tri_a, 0.0)

    sum_n = tri_n.sum(axis=1)
    sum_a = tri_a.sum(axis=1)
    sum_ac = (tri_a[:, :, None] * tri_c).sum(axis=1)

    small = sum_a < 1e-30
    ctr = np.where(small[:, None], c_est, sum_ac / np.maximum(sum_a, 1e-300)[:, None] / 3.0)
    area = 0.5 * sum_n
    # triangles degenerate for 3-point faces handled fine by the same formula
    return ctr, area


def cell_centres_volumes(
    owner: np.ndarray,
    neighbour: np.ndarray,
    n_cells: int,
    cf: np.ndarray,
    sf: np.ndarray,
    face_shift: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cell centres/volumes by pyramid decomposition about the estimated
    centre (average of face centres), as in the reference. face_shift
    [nIf,3] is the translation of internalised cyclic faces: the
    neighbour cell sees the face at cf + shift (its own side of the
    periodic gap)."""
    n_ifaces = neighbour.shape[0]
    cf_nei = cf[:n_ifaces]
    if face_shift is not None:
        cf_nei = cf_nei + face_shift
    # estimated centre: average of face centres over each cell's faces
    c_est = np.zeros((n_cells, 3))
    n_cf = np.zeros(n_cells)
    np.add.at(c_est, owner, cf)
    np.add.at(n_cf, owner, 1.0)
    np.add.at(c_est, neighbour, cf_nei)
    np.add.at(n_cf, neighbour, 1.0)
    c_est /= n_cf[:, None]

    vol = np.zeros(n_cells)
    ctr = np.zeros((n_cells, 3))

    def accum(cells, sign, cf_, sf_):
        pyr3vol = sign * np.einsum("fi,fi->f", sf_, cf_ - c_est[cells])
        pc = 0.75 * cf_ + 0.25 * c_est[cells]
        np.add.at(vol, cells, pyr3vol)
        np.add.at(ctr, cells, pyr3vol[:, None] * pc)

    accum(owner, 1.0, cf, sf)
    accum(neighbour, -1.0, cf_nei, sf[:n_ifaces])

    ctr = np.where(np.abs(vol)[:, None] > 1e-300, ctr / vol[:, None], c_est)
    vol = vol / 3.0
    return ctr, vol


# ---------------------------------------------------------------------------
# Host mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PolyMesh:
    """Host-side mesh: topology + derived geometry (NumPy, float64)."""

    points: np.ndarray          # [nPts, 3]
    face_pts: np.ndarray        # [nF, maxPts] padded with -1
    face_npts: np.ndarray       # [nF]
    owner: np.ndarray           # [nF]
    neighbour: np.ndarray       # [nIf]
    patches: List[Patch]
    # translation of internalised cyclic faces [nIf,3] (None = all zero):
    # the neighbour cell's copy of the face sits at cf + face_shift
    face_shift: np.ndarray = None
    # named cell zones: {name: [nZoneCells] int cell ids} (reference:
    # polyMesh/zones/cellZone — used by MRF/porous/fvOptions selection)
    cell_zones: Dict[str, np.ndarray] = None

    # derived (filled by update_geometry)
    cf: np.ndarray = None       # face centres [nF,3]
    sf: np.ndarray = None       # face area vectors [nF,3]
    mag_sf: np.ndarray = None   # [nF]
    c: np.ndarray = None        # cell centres [nC,3]
    v: np.ndarray = None        # cell volumes [nC]
    weights: np.ndarray = None  # interpolation weights [nF] (boundary = 1)
    delta_coeffs: np.ndarray = None       # [nF]
    non_orth_delta_coeffs: np.ndarray = None  # [nF]
    correction_vecs: np.ndarray = None    # [nF,3] non-orthogonality correction

    def __post_init__(self):
        self.owner = np.asarray(self.owner, dtype=np.int64)
        self.neighbour = np.asarray(self.neighbour, dtype=np.int64)
        if self.cell_zones is None:
            self.cell_zones = {}
        if self.cf is None:
            self.update_geometry()

    # -- sizes --------------------------------------------------------------
    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_faces(self) -> int:
        return self.owner.shape[0]

    @property
    def n_internal_faces(self) -> int:
        return self.neighbour.shape[0]

    @property
    def n_boundary_faces(self) -> int:
        return self.n_faces - self.n_internal_faces

    @property
    def n_cells(self) -> int:
        m = int(self.owner.max()) if self.owner.size else -1
        if self.neighbour.size:
            m = max(m, int(self.neighbour.max()))
        return m + 1

    def patch(self, name: str) -> Patch:
        for p in self.patches:
            if p.name == name:
                return p
        raise KeyError(f"no patch named {name!r}")

    # -- geometry -----------------------------------------------------------
    def update_geometry(self) -> None:
        self.cf, self.sf = face_centres_areas(self.points, self.face_pts, self.face_npts)
        self.mag_sf = np.linalg.norm(self.sf, axis=1)
        self.c, self.v = cell_centres_volumes(
            self.owner, self.neighbour, self.n_cells, self.cf, self.sf,
            self.face_shift,
        )
        self._update_interpolation()

    def _update_interpolation(self) -> None:
        nif = self.n_internal_faces
        own, nei = self.owner[:nif], self.neighbour
        sf, cf = self.sf[:nif], self.cf[:nif]
        c_nei = self.c[nei]
        if self.face_shift is not None:
            # cyclic-internalised faces: bring the neighbour cell centre
            # into the owner side's frame
            c_nei = c_nei - self.face_shift

        sfd_own = np.abs(np.einsum("fi,fi->f", sf, cf - self.c[own]))
        sfd_nei = np.abs(np.einsum("fi,fi->f", sf, c_nei - cf))
        w = np.ones(self.n_faces)
        w[:nif] = sfd_nei / np.maximum(sfd_own + sfd_nei, 1e-300)
        self.weights = w

        delta = np.empty((self.n_faces, 3))
        delta[:nif] = c_nei - self.c[own]
        bsl = slice(nif, self.n_faces)
        delta[bsl] = self.cf[bsl] - self.c[self.owner[bsl]]
        mag_delta = np.linalg.norm(delta, axis=1)
        self.delta_coeffs = 1.0 / np.maximum(mag_delta, 1e-300)

        nhat = self.sf / np.maximum(self.mag_sf, 1e-300)[:, None]
        sn = np.einsum("fi,fi->f", nhat, delta)
        self.non_orth_delta_coeffs = 1.0 / np.maximum(sn, 0.05 * mag_delta)
        self.correction_vecs = nhat - delta * self.non_orth_delta_coeffs[:, None]
        # empty patches get zero correction (no flux through them anyway)

    # -- cell->face adjacency (gather tables) --------------------------------
    def cell_tables(self) -> Dict[str, np.ndarray]:
        """Build padded per-cell gather tables.

        Returns arrays of shape [nC, K] with K = max faces/cell:
          cface       face index (pad -> 0)
          csign       +1 cell is owner / -1 neighbour / 0 pad
          cnbr        adjacent cell across internal face (pad/boundary -> 0)
          cnbr_valid  1.0 for internal faces, else 0.0
          cbnd        1.0 for boundary faces, else 0.0
          cface_i     face index clamped to internal range (for upper/lower gathers)
        """
        nC, nF, nIf = self.n_cells, self.n_faces, self.n_internal_faces
        counts = np.zeros(nC, dtype=np.int64)
        np.add.at(counts, self.owner, 1)
        np.add.at(counts, self.neighbour, 1)
        K = int(counts.max())

        cface = np.zeros((nC, K), dtype=np.int64)
        csign = np.zeros((nC, K))
        cnbr = np.zeros((nC, K), dtype=np.int64)
        cnbr_valid = np.zeros((nC, K))
        cbnd = np.zeros((nC, K))

        own_counts = np.bincount(self.owner, minlength=nC)

        def slots(cells):
            """Rank of each entry within its cell group (vectorized)."""
            order = np.argsort(cells, kind="stable")
            sorted_cells = cells[order]
            group_start = np.zeros(nC, dtype=np.int64)
            cnts = np.bincount(sorted_cells, minlength=nC)
            group_start[1:] = np.cumsum(cnts)[:-1]
            rank = np.arange(cells.shape[0]) - group_start[sorted_cells]
            inv = np.empty_like(order)
            inv[order] = rank
            return inv

        # owner side: slots 0..own_counts-1
        faces = np.arange(nF)
        k_o = slots(self.owner)
        cface[self.owner, k_o] = faces
        csign[self.owner, k_o] = 1.0
        cnbr[self.owner[:nIf], k_o[:nIf]] = self.neighbour
        cnbr_valid[self.owner[:nIf], k_o[:nIf]] = 1.0
        cbnd[self.owner[nIf:], k_o[nIf:]] = 1.0

        # neighbour side: slots continue after the owner-side count
        k_n = own_counts[self.neighbour] + slots(self.neighbour)
        ifaces = np.arange(nIf)
        cface[self.neighbour, k_n] = ifaces
        csign[self.neighbour, k_n] = -1.0
        cnbr[self.neighbour, k_n] = self.owner[:nIf]
        cnbr_valid[self.neighbour, k_n] = 1.0

        cface_i = np.minimum(cface, max(nIf - 1, 0))
        out = dict(
            cface=cface,
            csign=csign,
            cnbr=cnbr,
            cnbr_valid=cnbr_valid,
            cbnd=cbnd,
            cface_i=cface_i,
            max_faces=K,
        )
        out.update(offset_stencil(cface_i, csign, cnbr, cnbr_valid, nC))
        return out


def internalize_cyclics(pm: PolyMesh) -> PolyMesh:
    """Convert translationally-coupled cyclic patch pairs into internal
    faces (reference: cyclicPolyPatch + cyclicFvPatchField,
    src/OpenFOAM/meshes/polyMesh/polyPatches/constraint/cyclic/).

    Design: instead of a coupled-interface update per solver
    sweep, each cyclic face pair becomes ONE internal face whose
    neighbour sits across the periodic gap; the separation vector is
    recorded in PolyMesh.face_shift so deltas/weights are exact. The
    periodic coupling then rides the ordinary offset-stencil machinery —
    jnp.roll is itself periodic, so a renumbered periodic direction
    costs nothing extra. Rotational cyclics (transform rotational) are
    not supported yet and raise.
    """
    cyc = {p.name: p for p in pm.patches if p.type == "cyclic"}
    if not cyc:
        return pm
    pairs = []
    done = set()
    for name, p in cyc.items():
        if name in done:
            continue
        nbr_name = p.neighbour_patch
        if nbr_name is None:
            # find the partner pointing at us
            for q in cyc.values():
                if q.neighbour_patch == name:
                    nbr_name = q.name
                    break
        if nbr_name is None or nbr_name not in cyc:
            raise ValueError(f"cyclic patch {name!r} has no partner")
        q = cyc[nbr_name]
        pairs.append((p, q))
        done.add(p.name)
        done.add(q.name)

    nif = pm.n_internal_faces
    drop = np.zeros(pm.n_faces, dtype=bool)
    new_own, new_nei, new_rows, new_shift = [], [], [], []
    for p, q in pairs:
        if p.size != q.size:
            raise ValueError(
                f"cyclic pair {p.name}/{q.name} sizes differ")
        cfa = pm.cf[p.slice]
        cfb = pm.cf[q.slice]
        T = cfb.mean(axis=0) - cfa.mean(axis=0)
        # match faces by shifted centre (translational transform only)
        scale = max(float(np.max(np.abs(cfb - cfb.mean(axis=0)))), 1e-12)
        key_a = np.round((cfa + T) / (1e-6 * scale)).astype(np.int64)
        key_b = np.round(cfb / (1e-6 * scale)).astype(np.int64)
        oa = np.lexsort(key_a.T)
        ob = np.lexsort(key_b.T)
        if not np.allclose(cfa[oa] + T, cfb[ob], atol=1e-4 * scale):
            raise ValueError(
                f"cyclic pair {p.name}/{q.name}: faces do not match under "
                "a pure translation (rotational cyclics not supported yet)")
        fa = p.start + oa
        fb = q.start + ob
        own_a = pm.owner[fa]
        own_b = pm.owner[fb]
        # keep owner < neighbour: take A's polygon when ownA <= ownB,
        # else B's (each patch's faces point OUT of their own cell, so
        # whichever polygon we keep is correctly owner-outward)
        use_a = own_a <= own_b
        rows = np.where(use_a, fa, fb)
        new_own.append(np.where(use_a, own_a, own_b))
        new_nei.append(np.where(use_a, own_b, own_a))
        new_rows.append(rows)
        new_shift.append(np.where(use_a[:, None], T[None, :], -T[None, :]))
        drop[fa] = True
        drop[fb] = True

    new_rows = np.concatenate(new_rows)
    add_shift = np.concatenate(new_shift)
    n_add = new_rows.shape[0]
    keep_b = ~drop
    keep_b[:nif] = False
    keep_idx = np.nonzero(keep_b)[0]

    order = np.concatenate([np.arange(nif), new_rows, keep_idx])
    face_pts = pm.face_pts[order]
    face_npts = pm.face_npts[order]
    owner = np.concatenate([pm.owner[:nif], np.concatenate(new_own),
                            pm.owner[keep_idx]])
    neighbour = np.concatenate([pm.neighbour, np.concatenate(new_nei)])
    shift = np.zeros((nif + n_add, 3))
    shift[nif:] = add_shift

    # rebuild surviving boundary patches with new starts
    patches = []
    start = nif + n_add
    for p in pm.patches:
        if p.type == "cyclic":
            continue
        patches.append(Patch(name=p.name, type=p.type, start=start,
                             size=p.size, neighbour_patch=p.neighbour_patch))
        start += p.size

    return PolyMesh(points=pm.points, face_pts=face_pts,
                    face_npts=face_npts, owner=owner, neighbour=neighbour,
                    patches=patches, face_shift=shift,
                    cell_zones=dict(pm.cell_zones or {}))


def offset_stencil(cface_i, csign, cnbr, valid, n_cells, max_offsets=8):
    """Offset-canonical neighbor tables — the SpMV design.

    After renumbering, almost all cell->neighbour hops are one of a few
    constant index offsets (structured interior: exactly +-1, +-nx,
    +-nx*ny — the CuthillMcKee locality the reference exploits for
    cache, reference: src/renumber/). We canonicalise slots so slot m
    always means "neighbour at offset d_m"; the SpMV becomes
    sum_m coeff[:,m] * roll(psi, -d_m) — pure vector ops. The
    unstructured remainder goes to a small COO fallback gather.

    Returns: st_cface [nC,M], st_sign, st_valid, st_deltas (tuple),
    fb_cells/fb_faces/fb_signs/fb_nbrs (1-D COO fallback).
    """
    idx = np.arange(n_cells)[:, None]
    deltas_all = np.where(valid > 0, cnbr - idx, 0)
    vals, counts = np.unique(deltas_all[valid > 0], return_counts=True)
    order = np.argsort(-counts)
    chosen = [int(v) for v in vals[order][:max_offsets]]
    M = max(len(chosen), 1)
    K = cface_i.shape[1]

    st_cface = np.zeros((n_cells, M), dtype=np.int64)
    st_sign = np.zeros((n_cells, M))
    st_valid = np.zeros((n_cells, M))
    covered = np.zeros_like(valid, dtype=bool)
    for m, d in enumerate(chosen):
        match = (deltas_all == d) & (valid > 0) & ~covered
        k_sel = np.argmax(match, axis=1)
        has = match.any(axis=1)
        rows = np.nonzero(has)[0]
        ks = k_sel[rows]
        st_cface[rows, m] = cface_i[rows, ks]
        st_sign[rows, m] = csign[rows, ks]
        st_valid[rows, m] = 1.0
        covered[rows, ks] = True

    fb = (valid > 0) & ~covered
    fb_cells, fb_k = np.nonzero(fb)
    return dict(
        st_cface=st_cface,
        st_sign=st_sign,
        st_valid=st_valid,
        st_deltas=tuple(chosen),
        fb_cells=fb_cells.astype(np.int64),
        fb_faces=cface_i[fb_cells, fb_k],
        fb_signs=csign[fb_cells, fb_k],
        fb_nbrs=cnbr[fb_cells, fb_k],
    )


# ---------------------------------------------------------------------------
# Device mesh (jnp pytree)
# ---------------------------------------------------------------------------


def _pytree_dataclass(cls):
    import jax

    fields = [f.name for f in dataclasses.fields(cls)]
    meta = [f.name for f in dataclasses.fields(cls) if f.metadata.get("static")]
    data = [n for n in fields if n not in meta]
    return jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)


def _static(**kw):
    return dataclasses.field(metadata={"static": True}, **kw)


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class FvMesh:
    """Device-side FV mesh: flat geometry arrays + gather tables.

    All float arrays use the framework scalar dtype (f32 by default);
    indices are int32. Static metadata (sizes, patches) lives in the
    pytree aux data so jit treats it as compile-time constant.
    """

    # geometry
    sf: Any            # [nF,3] face area vectors
    mag_sf: Any        # [nF]
    cf: Any            # [nF,3] face centres
    c: Any             # [nC,3] cell centres
    v: Any             # [nC] volumes
    weights: Any       # [nF] linear interpolation weights (owner side)
    delta_coeffs: Any  # [nF]
    non_orth_delta_coeffs: Any  # [nF]
    correction_vecs: Any        # [nF,3]
    face_active: Any   # [nF] 1.0 everywhere except empty-patch faces
    owner: Any         # [nF] int32
    neighbour: Any     # [nIf] int32

    # gather tables [nC, K]
    cface: Any
    csign: Any
    cnbr: Any
    cnbr_valid: Any
    cbnd: Any
    cface_i: Any

    # offset-canonical stencil tables (see offset_stencil)
    st_cface: Any      # [nC, M]
    st_sign: Any
    st_valid: Any
    fb_cells: Any      # COO fallback for non-stencil neighbours
    fb_faces: Any
    fb_signs: Any
    fb_nbrs: Any

    # slot-form geometry (host-gathered once at load): face quantities
    # addressed [nC, M] so the hot path touches faces through ROLLS
    # (contiguous shifted reads), not index gathers.
    st_wself: Any      # [nC,M] interpolation weight of the CELL's side
    st_magsf: Any      # [nC,M]
    st_dc: Any         # [nC,M] delta coeffs
    st_nodc: Any       # [nC,M] non-orthogonal delta coeffs
    st_sf: Any         # [nC,M,3] OUTWARD-signed face area vector
    st_corr: Any       # [nC,M,3] non-orthogonality correction vectors
    fb_wself: Any      # fallback twins [nfb,...]
    fb_magsf: Any
    fb_dc: Any
    fb_nodc: Any
    fb_sf: Any
    fb_corr: Any
    # slot -> flat extraction: for each internal face, the linear index
    # of its OWNER side in the [nC*M] slot array (-1 if the owner side
    # lives in the fallback), plus the fallback extraction pairs
    ex_own_lin: Any    # [nIf] int32
    ex_fb_faces: Any   # [nfb_own] int32 face ids
    ex_fb_idx: Any     # [nfb_own] int32 fb-entry ids
    # wall adjacency (for wall functions): 1/0 mask of wall-adjacent
    # cells, the average wall distance of those cells, and the wall-face
    # count per cell (>=1 clamp) — precomputed so models need no host
    # topology access inside jit
    wall_mask: Any     # [nC]
    wall_y: Any        # [nC]
    wall_cnt: Any      # [nC]

    # compact ACTIVE boundary-face indexing: a 2D case stores 2*nC
    # empty-patch faces in the flat [nBf] boundary arrays, and full-size
    # boundary gathers/scatters are index-rate-bound (~150M idx/s) — a
    # 321k-index scatter costs ~4.5 ms at 400^2. All hot-path
    # boundary motion goes through these instead (the empty faces
    # contribute exactly zero by the face_active mask).
    ab_rel: Any        # [nAB] int32, boundary-relative active face ids
    ab_owner: Any      # [nAB] int32 owner cells
    ab_sf: Any         # [nAB,3] outward face area vectors

    # cyclicAMI interpolation tables (mesh/ami.py): COO entries
    # face-of-A <- owner-cell-of-B with normalised overlap weights;
    # empty arrays when the mesh has no AMI interfaces
    ami_entry_face: Any   # [nE] int32 boundary-relative receiving face
    ami_entry_row: Any    # [nE] int32 owner cell of receiving face
    ami_entry_cell: Any   # [nE] int32 source owner cell
    ami_entry_w: Any      # [nE]
    ami_mask: Any         # [nBf] 1.0 on cyclicAMI faces
    ami_wown: Any         # [nBf] own-side blend weight (1 off AMI)
    # {zone name: [nC] 1/0 float mask} (reference: polyMesh cellZones);
    # a dict pytree node so masks ride to the device with the mesh
    cell_zone_masks: Any

    # static metadata
    st_deltas: Tuple[int, ...] = _static()
    n_cells: int = _static()
    n_faces: int = _static()
    n_internal_faces: int = _static()
    max_faces: int = _static()
    patches: Tuple[Patch, ...] = _static()
    # True when every internal face is orthogonal (|k| ~ 0): corrected
    # snGrad/laplacian schemes then skip the explicit correction
    # entirely at trace time (it is identically zero — reference:
    # orthogonal meshes take the uncorrected path for free)
    orthogonal: bool = _static(default=False)
    has_ami: bool = _static(default=False)

    @property
    def n_boundary_faces(self) -> int:
        return self.n_faces - self.n_internal_faces

    def patch(self, name: str) -> Patch:
        for p in self.patches:
            if p.name == name:
                return p
        raise KeyError(f"no patch named {name!r}")

    def boundary_owner(self):
        """Owner cells of all boundary faces, [nBf] int32."""
        return self.owner[self.n_internal_faces :]


def to_device(mesh: PolyMesh) -> FvMesh:
    """Build the FvMesh pytree. All arrays are staged in NumPy and moved
    with ONE jax.device_put. Cyclic patch pairs are internalised here
    (see internalize_cyclics)."""
    import jax

    if any(p.type == "cyclic" for p in mesh.patches):
        mesh = internalize_cyclics(mesh)

    sdt = scalar_np()
    tabs = mesh.cell_tables()

    face_active = np.ones(mesh.n_faces, dtype=sdt)
    for p in mesh.patches:
        if p.type == "empty":
            face_active[p.slice] = 0.0

    nif = mesh.n_internal_faces
    corr_int = mesh.correction_vecs[:nif]
    orthogonal = bool(
        corr_int.size == 0 or np.max(np.linalg.norm(corr_int, axis=1)) < 1e-6
    )

    # -- slot-form geometry (host gathers, free at load) ----------------------
    st_cf = tabs["st_cface"]          # [nC,M] internal face ids (clamped)
    st_v = tabs["st_valid"]
    st_s = tabs["st_sign"]
    w_i = mesh.weights[st_cf]
    st_wself = np.where(st_s > 0, w_i, 1.0 - w_i) * st_v
    st_magsf = mesh.mag_sf[st_cf] * st_v
    st_dc = mesh.delta_coeffs[st_cf] * st_v
    st_nodc = mesh.non_orth_delta_coeffs[st_cf] * st_v
    st_sf = mesh.sf[st_cf] * (st_v * st_s)[:, :, None]
    st_corr_t = mesh.correction_vecs[st_cf] * st_v[:, :, None]

    fb_f = tabs["fb_faces"]
    fb_s = tabs["fb_signs"]
    if fb_f.shape[0]:
        fb_w = mesh.weights[fb_f]
        fb_wself = np.where(fb_s > 0, fb_w, 1.0 - fb_w)
        fb_magsf = mesh.mag_sf[fb_f]
        fb_dc = mesh.delta_coeffs[fb_f]
        fb_nodc = mesh.non_orth_delta_coeffs[fb_f]
        fb_sf = mesh.sf[fb_f] * fb_s[:, None]
        fb_corr = mesh.correction_vecs[fb_f]
    else:
        fb_wself = np.zeros((0,))
        fb_magsf = np.zeros((0,))
        fb_dc = np.zeros((0,))
        fb_nodc = np.zeros((0,))
        fb_sf = np.zeros((0, 3))
        fb_corr = np.zeros((0, 3))

    # slot -> flat extraction tables (every internal face's OWNER side
    # lives either in the st tables or in the fallback)
    M = st_cf.shape[1]
    ex_own_lin = np.full(nif, -1, dtype=np.int64)
    rows, slots = np.nonzero((st_s > 0) & (st_v > 0))
    ex_own_lin[st_cf[rows, slots]] = rows * M + slots
    own_fb = np.nonzero(fb_s > 0)[0]
    ex_fb_faces = fb_f[own_fb]
    ex_fb_idx = own_fb
    missing = int(np.sum(ex_own_lin < 0)) - ex_fb_faces.shape[0]
    assert missing == 0, f"{missing} internal faces lack an owner side"
    ex_own_lin = np.maximum(ex_own_lin, 0)

    # wall adjacency (reference: wall functions act on wall-adjacent
    # cells via patch().faceCells() + 1/deltaCoeffs)
    wall_mask = np.zeros(mesh.n_cells)
    wall_yacc = np.zeros(mesh.n_cells)
    wall_cnt = np.zeros(mesh.n_cells)
    for p in mesh.patches:
        if p.type != "wall":
            continue
        cells = mesh.owner[p.slice]
        yw = 1.0 / np.maximum(mesh.delta_coeffs[p.slice], 1e-300)
        np.add.at(wall_yacc, cells, yw)
        np.add.at(wall_cnt, cells, 1.0)
        wall_mask[cells] = 1.0
    wall_y = np.where(wall_cnt > 0, wall_yacc / np.maximum(wall_cnt, 1.0),
                      1.0)

    # compact active-boundary tables (skip empty-patch faces entirely)
    ab_rel = np.nonzero(face_active[nif:] > 0)[0].astype(np.int64)
    ab_owner = mesh.owner[nif:][ab_rel]
    ab_sf = mesh.sf[nif:][ab_rel]

    # cyclicAMI interpolation tables
    from . import ami as ami_mod

    ami = ami_mod.build(mesh)
    dcs_all = mesh.delta_coeffs
    nodcs_all = mesh.non_orth_delta_coeffs
    if ami is None:
        nbf_ = mesh.n_faces - nif
        ami_ef = np.zeros(0, dtype=np.int64)
        ami_er = np.zeros(0, dtype=np.int64)
        ami_ec = np.zeros(0, dtype=np.int64)
        ami_ew = np.zeros(0)
        ami_mask = np.zeros(nbf_)
        ami_wown = np.ones(nbf_)
    else:
        ami_ef, ami_er = ami.entry_face, ami.entry_row
        ami_ec, ami_ew = ami.entry_cell, ami.entry_w
        ami_mask = ami.face_mask
        ami_wown = ami.w_own
        # coupled faces carry the two-sided (cell-to-cell) delta
        dcs_all = dcs_all.copy()
        nodcs_all = nodcs_all.copy()
        on = ami.face_mask > 0
        dcs_all[nif:][on] = ami.dc_eff[on]
        nodcs_all[nif:][on] = ami.dc_eff[on]

    def farr(a):
        return np.asarray(a, dtype=sdt)

    def iarr(a):
        return np.asarray(a, dtype=label_np)

    fv = FvMesh(
        sf=farr(mesh.sf),
        mag_sf=farr(mesh.mag_sf),
        cf=farr(mesh.cf),
        c=farr(mesh.c),
        v=farr(mesh.v),
        weights=farr(mesh.weights),
        delta_coeffs=farr(dcs_all),
        non_orth_delta_coeffs=farr(nodcs_all),
        correction_vecs=farr(mesh.correction_vecs),
        face_active=face_active,
        owner=iarr(mesh.owner),
        neighbour=iarr(mesh.neighbour),
        cface=iarr(tabs["cface"]),
        csign=farr(tabs["csign"]),
        cnbr=iarr(tabs["cnbr"]),
        cnbr_valid=farr(tabs["cnbr_valid"]),
        cbnd=farr(tabs["cbnd"]),
        cface_i=iarr(tabs["cface_i"]),
        st_cface=iarr(tabs["st_cface"]),
        st_sign=farr(tabs["st_sign"]),
        st_valid=farr(tabs["st_valid"]),
        fb_cells=iarr(tabs["fb_cells"]),
        fb_faces=iarr(tabs["fb_faces"]),
        fb_signs=farr(tabs["fb_signs"]),
        fb_nbrs=iarr(tabs["fb_nbrs"]),
        st_wself=farr(st_wself),
        st_magsf=farr(st_magsf),
        st_dc=farr(st_dc),
        st_nodc=farr(st_nodc),
        st_sf=farr(st_sf),
        st_corr=farr(st_corr_t),
        fb_wself=farr(fb_wself),
        fb_magsf=farr(fb_magsf),
        fb_dc=farr(fb_dc),
        fb_nodc=farr(fb_nodc),
        fb_sf=farr(fb_sf),
        fb_corr=farr(fb_corr),
        ex_own_lin=iarr(ex_own_lin),
        ex_fb_faces=iarr(ex_fb_faces),
        ex_fb_idx=iarr(ex_fb_idx),
        wall_mask=farr(wall_mask),
        wall_y=farr(wall_y),
        wall_cnt=farr(np.maximum(wall_cnt, 1.0)),
        ab_rel=iarr(ab_rel),
        ab_owner=iarr(ab_owner),
        ab_sf=farr(ab_sf),
        ami_entry_face=iarr(ami_ef),
        ami_entry_row=iarr(ami_er),
        ami_entry_cell=iarr(ami_ec),
        ami_entry_w=farr(ami_ew),
        ami_mask=farr(ami_mask),
        ami_wown=farr(ami_wown),
        st_deltas=tabs["st_deltas"],
        n_cells=mesh.n_cells,
        n_faces=mesh.n_faces,
        n_internal_faces=mesh.n_internal_faces,
        max_faces=int(tabs["max_faces"]),
        patches=tuple(mesh.patches),
        orthogonal=orthogonal,
        has_ami=ami is not None,
        cell_zone_masks={
            name: farr(np.bincount(
                np.asarray(ids, dtype=np.int64),
                minlength=mesh.n_cells).astype(float).clip(0, 1))
            for name, ids in (mesh.cell_zones or {}).items()},
    )
    return jax.device_put(fv)
