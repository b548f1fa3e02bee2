"""Command-line utilities — the applications/utilities equivalents.

Usage (via the foamtpu package):
    python -m foamtpu blockMesh  -case <dir>
    python -m foamtpu checkMesh  -case <dir>
    python -m foamtpu run        -case <dir> [-steps N]   # runs controlDict application
    python -m foamtpu decomposePar -case <dir>            # prints partition summary
    python -m foamtpu foamToVTK  -case <dir> [-time t]

Reference: applications/utilities/mesh/generation/blockMesh/,
mesh/manipulation/checkMesh/, postProcessing/dataConversion/foamToVTK/.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _case_arg(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-steps", type=int, default=None)
    ap.add_argument("-time", default=None)
    ap.add_argument("-parallel", action="store_true",
                    help="shard the case over all local devices (GSPMD)")
    return ap.parse_args(argv)


def block_mesh(argv) -> int:
    args = _case_arg(argv)
    from ..core.dictionary import parse_file
    from ..io import polymesh as mesh_io
    from ..mesh import blockmesh

    for cand in ("constant/polyMesh/blockMeshDict", "system/blockMeshDict"):
        path = os.path.join(args.case, cand)
        if os.path.exists(path):
            break
    else:
        print("blockMesh: no blockMeshDict found", file=sys.stderr)
        return 1
    mesh = blockmesh.generate(path)
    out = os.path.join(args.case, "constant", "polyMesh")
    mesh_io.write(mesh, out)
    print(f"blockMesh: wrote {mesh.n_cells} cells, {mesh.n_faces} faces, "
          f"{len(mesh.patches)} patches -> {out}")
    return 0


def check_mesh(argv) -> int:
    args = _case_arg(argv)
    from ..io import polymesh as mesh_io
    from ..mesh.check import check

    mesh = mesh_io.read(os.path.join(args.case, "constant", "polyMesh"))
    stats = check(mesh, verbose=True)
    print("Mesh OK.")
    return 0


def run(argv) -> int:
    args = _case_arg(argv)
    from ..core.case import run_case

    run_case(args.case, max_steps=args.steps,
             parallel=getattr(args, "parallel", False))
    return 0


def decompose_par(argv) -> int:
    args = _case_arg(argv)
    from ..core.dictionary import parse_file
    from ..io import polymesh as mesh_io
    from ..parallel import partition

    mesh = mesh_io.read(os.path.join(args.case, "constant", "polyMesh"))
    dd_path = os.path.join(args.case, "system", "decomposeParDict")
    n, method, coeffs = 4, "rcb", None
    if os.path.exists(dd_path):
        dd = parse_file(dd_path)
        n = int(dd.get("numberOfSubdomains", 4))
        method = str(dd.get("method", "rcb"))
        coeffs = dd.get(method + "Coeffs", dd.get("coeffs", None))
        if method == "manual" and coeffs and "dataFile" in coeffs:
            df = str(coeffs["dataFile"])
            if not os.path.isabs(df):
                coeffs = dict(coeffs)
                coeffs["dataFile"] = os.path.join(args.case, df)
        if method in ("scotch", "metis"):
            # graph partitioners map to RCB (documented replacement)
            method = "rcb"
    parts = partition.decompose(mesh, n, method=method, coeffs=coeffs)
    import numpy as np

    sizes = np.bincount(parts, minlength=n)
    cut = partition.cut_faces(mesh, parts)
    print(f"decomposePar: {n} subdomains, cell counts {sizes.tolist()}, "
          f"{cut} cut faces (on-device GSPMD sharding uses this ordering)")
    return 0


def foam_to_vtk(argv) -> int:
    args = _case_arg(argv)
    from ..io import vtk as vtk_io

    out = vtk_io.case_to_vtk(args.case, time_name=args.time)
    print(f"foamToVTK: wrote {out}")
    return 0


def set_fields(argv) -> int:
    """setFields: initialise field regions from system/setFieldsDict
    (reference: applications/utilities/preProcessing/setFields/).
    Supports boxToCell + volScalar/VectorFieldValue."""
    import jax.numpy as jnp
    import numpy as np

    from ..core.case import Case
    from ..core.dictionary import parse_file
    from ..io import fields as field_io

    args = _case_arg(argv)
    case = Case(args.case)
    mesh = case.mesh
    d = parse_file(os.path.join(args.case, "system", "setFieldsDict"))

    def parse_values(lst):
        out = {}
        items = list(lst) if isinstance(lst, list) else [lst]
        i = 0
        while i < len(items) - 2:
            if str(items[i]).endswith("FieldValue"):
                out[str(items[i + 1])] = items[i + 2]
                i += 3
            else:
                i += 1
        return out

    fields = {}
    for name, val in parse_values(d.get("defaultFieldValues", [])).items():
        f = case.read_field(name)
        v = jnp.broadcast_to(jnp.asarray(np.asarray(val, dtype=float),
                                         mesh.v.dtype), f.data.shape)
        fields[name] = f.with_data(v)

    c = np.asarray(mesh.c)
    regions = d.get("regions", [])
    items = list(regions) if isinstance(regions, list) else [regions]
    i = 0
    while i < len(items):
        kind = str(items[i])
        spec = items[i + 1] if i + 1 < len(items) else None
        i += 2
        if kind != "boxToCell" or spec is None:
            continue
        box = np.asarray(spec["box"], dtype=float).reshape(2, 3)
        mask = np.all((c >= box[0]) & (c <= box[1]), axis=1)
        for name, val in parse_values(spec.get("fieldValues", [])).items():
            f = fields.get(name) or case.read_field(name)
            v = jnp.asarray(np.asarray(val, dtype=float), mesh.v.dtype)
            data = np.array(f.data)  # writable host copy
            data[mask] = np.asarray(v)
            fields[name] = f.with_data(jnp.asarray(data))

    from ..core import runtime

    tname = runtime.time_name(case.time.start_time)
    for f in fields.values():
        field_io.write_field(f, mesh, case.dir, tname)
    print(f"setFields: updated {sorted(fields)} at time {tname}")
    return 0


def renumber_mesh(argv) -> int:
    """renumberMesh: RCM cell renumbering for bandwidth/locality
    (reference: applications/utilities/mesh/manipulation/renumberMesh/)."""
    args = _case_arg(argv)
    from ..io import polymesh as mesh_io
    from ..mesh import renumber as rn

    mdir = os.path.join(args.case, "constant", "polyMesh")
    mesh = mesh_io.read(mdir)
    bw0 = rn.bandwidth(mesh)
    new, order = rn.renumber(mesh)
    mesh_io.write(new, mdir)
    print(f"renumberMesh: bandwidth {bw0} -> {rn.bandwidth(new)}")
    return 0


def box_turb(argv) -> int:
    """boxTurb: divergence-free synthetic turbulence initial U field
    (reference: applications/utilities/preProcessing/boxTurb/ +
    constant/boxTurbDict {Ea; k0; seed;}). Requires a uniform
    single-box mesh; grid dims inferred from the cell centres."""
    args = _case_arg(argv)
    import jax.numpy as jnp
    import numpy as np

    from ..core.case import Case
    from ..core.dictionary import parse_file
    from ..core import runtime
    from ..io import fields as field_io
    from ..models import randomprocesses as rp

    case = Case(args.case)
    mesh = case.mesh
    d = parse_file(os.path.join(args.case, "constant", "boxTurbDict"))
    Ea = float(d.get("Ea", 1.0))
    k0 = float(d.get("k0", 5.0))
    seed = int(d.get("seed", 0))

    c = np.asarray(mesh.c)
    lo, hi = c.min(axis=0), c.max(axis=0)
    dims = []
    for ax in range(3):
        u = np.unique(np.round((c[:, ax] - lo[ax]) /
                               max(hi[ax] - lo[ax], 1e-30) * 1e6))
        dims.append(len(u))
    nx, ny, nz = dims
    assert nx * ny * nz == mesh.n_cells, (
        f"boxTurb needs a uniform box mesh; inferred {dims} vs "
        f"{mesh.n_cells} cells")
    L = hi - lo + (hi - lo) / (np.maximum(np.asarray(dims), 2) - 1 + 1e-30)
    u = rp.box_turb((nx, ny, nz), L, Ea, k0, seed)
    # map grid -> cell ordering via index lookup
    span = np.maximum(hi - lo, 1e-30)
    idx = np.round((c - lo) / span * (np.asarray(dims) - 1)).astype(int)
    flat = u[idx[:, 0], idx[:, 1], idx[:, 2], :]
    U = case.read_field("U")
    U = U.with_data(jnp.asarray(flat, mesh.v.dtype))
    tname = runtime.time_name(case.time.start_time)
    field_io.write_field(U, mesh, case.dir, tname)
    tke = 0.5 * float(np.mean(np.sum(flat * flat, axis=1)))
    print(f"boxTurb: wrote U ({nx}x{ny}x{nz}), k = {tke:.4g} "
          f"(target {1.5 * Ea:.4g})")
    return 0


def foam_list_times(argv) -> int:
    """foamListTimes (reference: applications/utilities/postProcessing/
    miscellaneous/foamListTimes/)."""
    args = _case_arg(argv)
    out = []
    for d in os.listdir(args.case):
        try:
            t = float(d)
        except ValueError:
            continue
        if os.path.isdir(os.path.join(args.case, d)) and t > 0:
            out.append((t, d))
    for _, d in sorted(out):
        print(d)
    return 0


def transform_points(argv) -> int:
    """transformPoints -translate/-rotate/-scale (reference:
    applications/utilities/mesh/manipulation/transformPoints/)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-translate", default=None)
    ap.add_argument("-scale", default=None)
    ap.add_argument("-rollPitchYaw", default=None)  # degrees
    args = ap.parse_args(argv)

    def vec3(s):
        return np.asarray([float(x) for x in
                           s.replace("(", " ").replace(")", " ").split()],
                          dtype=float)

    from ..io import polymesh as mesh_io

    mdir = os.path.join(args.case, "constant", "polyMesh")
    mesh = mesh_io.read(mdir)
    pts = np.asarray(mesh.points, dtype=float)
    if args.rollPitchYaw:
        r, p, y = np.deg2rad(vec3(args.rollPitchYaw))

        def rot(ax, ang):
            c, s = np.cos(ang), np.sin(ang)
            i, j = [(1, 2), (0, 2), (0, 1)][ax]
            R = np.eye(3)
            R[i, i] = R[j, j] = c
            R[i, j], R[j, i] = (-s, s) if ax != 1 else (s, -s)
            return R
        R = rot(2, y) @ rot(1, p) @ rot(0, r)
        pts = pts @ R.T
    if args.scale:
        s = vec3(args.scale)
        s = np.resize(s, 3)
        pts = pts * s
    if args.translate:
        pts = pts + vec3(args.translate)
    mesh.points = pts
    mesh.update_geometry()
    mesh_io.write(mesh, mdir)
    print(f"transformPoints: wrote {len(pts)} points")
    return 0


def map_fields(argv) -> int:
    """mapFields <sourceCase> -case <target>: nearest-cell mapping of
    the start-time fields (reference: applications/utilities/
    preProcessing/mapFields/ with -mapMethod cellPointInterpolate ->
    nearest here)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("source")
    ap.add_argument("-case", default=".")
    ap.add_argument("-sourceTime", default=None)
    args = ap.parse_args(argv)
    import jax.numpy as jnp
    from scipy.spatial import cKDTree

    from ..core import runtime
    from ..core.case import Case
    from ..io import fields as field_io

    src = Case(args.source)
    dst = Case(args.case)
    stime = args.sourceTime or runtime.time_name(src.time.start_time)
    tree = cKDTree(np.asarray(src.mesh.c))
    idx = tree.query(np.asarray(dst.mesh.c))[1]
    sdir = os.path.join(src.dir, stime)
    tname = runtime.time_name(dst.time.start_time)
    n = 0
    for fname in sorted(os.listdir(sdir)):
        if fname.endswith(".gz"):
            fname = fname[:-3]
        try:
            sf = src.read_field(fname, time=stime)
            df = dst.read_field(fname)
        except Exception:
            continue
        mapped = np.asarray(sf.data)[idx]
        field_io.write_field(df.with_data(jnp.asarray(
            mapped, dst.mesh.v.dtype)), dst.mesh, dst.dir, tname)
        n += 1
    print(f"mapFields: mapped {n} fields {args.source}:{stime} -> "
          f"{args.case}:{tname}")
    return 0


def patch_average(argv) -> int:
    """patchAverage <field> <patch> (reference: applications/utilities/
    postProcessing/patch/patchAverage/) — area-weighted average at the
    latest time."""
    ap = argparse.ArgumentParser()
    ap.add_argument("field")
    ap.add_argument("patch")
    ap.add_argument("-case", default=".")
    ap.add_argument("-time", default=None)
    args = ap.parse_args(argv)
    from ..core.case import Case

    case = Case(args.case)
    t = args.time or case.latest_time_name()
    f = case.read_field(args.field, time=t)
    mesh = case.mesh
    for p in mesh.patches:
        if p.name == args.patch:
            vals = np.asarray(f.data)[np.asarray(mesh.owner)[p.slice]]
            w = np.asarray(mesh.mag_sf)[p.slice]
            avg = (vals * (w[:, None] if vals.ndim == 2 else w)
                   ).sum(axis=0) / w.sum()
            print(f"Average of {args.field} over patch {args.patch} = "
                  f"{avg}")
            return 0
    print(f"patch {args.patch!r} not found", file=sys.stderr)
    return 1


def foam_calc(argv) -> int:
    """foamCalc mag|components <field> (reference: applications/
    utilities/postProcessing/foamCalc/) at the latest time."""
    ap = argparse.ArgumentParser()
    ap.add_argument("op", choices=["mag", "components"])
    ap.add_argument("field")
    ap.add_argument("-case", default=".")
    ap.add_argument("-time", default=None)
    args = ap.parse_args(argv)
    import jax.numpy as jnp

    from ..core.case import Case
    from ..io import fields as field_io

    case = Case(args.case)
    t = args.time or case.latest_time_name()
    f = case.read_field(args.field, time=t)
    data = np.asarray(f.data)
    mesh = case.mesh
    from ..bc.patchfields import default_bcs
    from ..core.fields import vol_scalar

    if args.op == "mag":
        out = vol_scalar(mesh, 0.0, name=f"mag({args.field})",
                         dims=f.dims).with_data(
            jnp.asarray(np.linalg.norm(np.atleast_2d(data.T).T, axis=-1)
                        if data.ndim == 2 else np.abs(data),
                        mesh.v.dtype))
        field_io.write_field(out, mesh, case.dir, t)
        print(f"foamCalc: wrote mag({args.field}) at {t}")
    else:
        for i, c in enumerate("xyz"[:data.shape[1]]):
            out = vol_scalar(mesh, 0.0, name=f"{args.field}{c}",
                             dims=f.dims).with_data(
                jnp.asarray(data[:, i], mesh.v.dtype))
            field_io.write_field(out, mesh, case.dir, t)
        print(f"foamCalc: wrote {args.field}{{x,y,z}} at {t}")
    return 0


def write_cell_centres(argv) -> int:
    """writeCellCentres (reference: applications/utilities/
    postProcessing/miscellaneous/writeCellCentres/)."""
    args = _case_arg(argv)
    import jax.numpy as jnp

    from ..core import runtime
    from ..core.case import Case
    from ..core.fields import vol_scalar
    from ..io import fields as field_io

    case = Case(args.case)
    mesh = case.mesh
    t = runtime.time_name(case.time.start_time)
    c = np.asarray(mesh.c)
    for i, name in enumerate(("ccx", "ccy", "ccz")):
        f = vol_scalar(mesh, 0.0, name=name).with_data(
            jnp.asarray(c[:, i], mesh.v.dtype))
        field_io.write_field(f, mesh, case.dir, t)
    print(f"writeCellCentres: wrote ccx/ccy/ccz at {t}")
    return 0


def topo_set_cmd(argv) -> int:
    """topoSet: create cell/face sets from system/topoSetDict
    (reference: applications/utilities/mesh/manipulation/topoSet/)."""
    args = _case_arg(argv)
    from . import meshutils

    names = meshutils.topo_set(args.case)
    print(f"topoSet: wrote sets {names}")
    return 0


def create_patch_cmd(argv) -> int:
    """createPatch: re-group boundary faces into new patches from
    faceSets/patch lists (reference: .../createPatch/)."""
    args = _case_arg(argv)
    from . import meshutils

    out = meshutils.create_patch(args.case)
    print(f"createPatch: patches now "
          f"{[(p.name, p.size) for p in out.patches]}")
    return 0


def extrude_mesh_cmd(argv) -> int:
    """extrudeMesh: linearNormal patch extrusion
    (reference: .../mesh/generation/extrudeMesh/)."""
    args = _case_arg(argv)
    from . import meshutils

    out = meshutils.extrude_mesh(args.case)
    print(f"extrudeMesh: {out.n_cells} cells, "
          f"{[p.name for p in out.patches]}")
    return 0


def refine_mesh_cmd(argv) -> int:
    """refineMesh: one 2x2x2 refinement level of a cellSet or the whole
    (uniform box) mesh (reference: .../refineMesh/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-set", dest="set_name", default=None)
    a = ap.parse_args(argv)
    from . import meshutils

    out = meshutils.refine_mesh(a.case, a.set_name)
    print(f"refineMesh: {out.n_cells} cells")
    return 0


def change_dictionary_cmd(argv) -> int:
    """changeDictionary: apply system/changeDictionaryDict replacements
    (reference: .../preProcessing/changeDictionary/)."""
    args = _case_arg(argv)
    from . import meshutils

    changed = meshutils.change_dictionary(args.case,
                                          time=args.time or "0")
    print(f"changeDictionary: updated {changed}")
    return 0


def gmsh_to_foam_cmd(argv) -> int:
    """gmshToFoam: convert a Gmsh MSH-2 ASCII mesh to polyMesh
    (reference: .../mesh/conversion/gmshToFoam/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("mshFile")
    ap.add_argument("-case", default=".")
    a = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from ..mesh import gmsh

    pm = gmsh.convert(a.mshFile)
    out = os.path.join(a.case, "constant", "polyMesh")
    mesh_io.write(pm, out)
    print(f"gmshToFoam: {pm.n_cells} cells, {pm.n_faces} faces, "
          f"patches {[p.name for p in pm.patches]} -> {out}")
    return 0


def split_mesh_regions_cmd(argv) -> int:
    """splitMeshRegions: label disconnected mesh regions, write one
    cellSet per region (reference: .../splitMeshRegions/ +
    meshTools/regionSplit)."""
    args = _case_arg(argv)
    from . import meshutils

    n = meshutils.split_mesh_regions(args.case)
    print(f"splitMeshRegions: {n} region(s)")
    return 0


def snappy_hex_mesh(argv) -> int:
    """snappyHexMesh (castellate + refine + snap + addLayers — see
    mesh/snappy.py + mesh/layers.py): carve the existing
    constant/polyMesh against the STL geometry in
    system/snappyHexMeshDict."""
    args = _case_arg(argv)
    from ..core.dictionary import parse_file
    from ..io import polymesh as mesh_io
    from ..mesh import snappy

    mdir = os.path.join(args.case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    d = parse_file(os.path.join(args.case, "system",
                                "snappyHexMeshDict"))
    out = snappy.from_dict(args.case, d, pm)
    mesh_io.write(out, mdir)
    print(f"snappyHexMesh: {pm.n_cells} -> "
          f"{out.n_cells} cells, patches "
          f"{[pt.name for pt in out.patches]}")
    return 0


def post_process(argv) -> int:
    """postProcess: run the controlDict functions{} objects over the
    SAVED time directories (reference: the 2.2-era
    execFlowFunctionObjects utility / later `postProcess`)."""
    args = _case_arg(argv)
    from ..core.case import Case
    from ..functionobjects import make_function_objects

    case = Case(args.case)
    fol = make_function_objects(case)
    if not fol.objects:
        print("postProcess: no functions{} in controlDict")
        return 0
    times = []
    for d in sorted(os.listdir(args.case)):
        try:
            t = float(d)
        except ValueError:
            continue
        if os.path.isdir(os.path.join(args.case, d)):
            times.append(d)
    if args.time is not None:
        times = [t for t in times if t == args.time]
    n = 0
    for t in times:
        state = {}
        for fname in sorted(os.listdir(os.path.join(args.case, t))):
            base = fname[:-3] if fname.endswith(".gz") else fname
            try:
                f = case.read_field(base, time=t)
            except Exception:
                continue
            key = {"p_rgh": "p_rgh"}.get(base, base)
            state[key] = f
        if not state:
            continue
        fol.execute(t, state)
        n += 1
        print(f"Time = {t}: processed {sorted(state)}")
    print(f"postProcess: {n} times")
    return 0



def mirror_mesh_cmd(argv) -> int:
    """mirrorMesh: reflect about system/mirrorMeshDict's plane
    (reference: .../mesh/manipulation/mirrorMesh/)."""
    args = _case_arg(argv)
    import numpy as np

    from ..core.dictionary import parse_file
    from ..io import polymesh as mesh_io
    from . import meshutils2

    mdir = os.path.join(args.case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    d = parse_file(os.path.join(args.case, "system", "mirrorMeshDict"))
    pd = d.get("pointAndNormalDict", d)
    point = [float(x) for x in np.asarray(
        pd.get("basePoint", pd.get("point", [0, 0, 0])),
        float).reshape(-1)[-3:]]
    normal = [float(x) for x in np.asarray(
        pd.get("normalVector", pd.get("normal", [1, 0, 0])),
        float).reshape(-1)[-3:]]
    out = meshutils2.mirror_mesh(pm, point, normal)
    mesh_io.write(out, mdir)
    print(f"mirrorMesh: {out.n_cells} cells")
    return 0


def subset_mesh_cmd(argv) -> int:
    """subsetMesh <cellSet>: extract a cellSet into a new mesh
    (reference: .../mesh/manipulation/subsetMesh/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("set_name")
    ap.add_argument("-case", default=".")
    ap.add_argument("-patch", default="oldInternalFaces")
    a = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from . import meshutils, meshutils2

    mdir = os.path.join(a.case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    ids = meshutils.read_set(a.case, a.set_name)
    out = meshutils2.subset_mesh(pm, ids, exposed_name=a.patch)
    mesh_io.write(out, mdir)
    print(f"subsetMesh: {out.n_cells} cells from set {a.set_name}")
    return 0


def merge_meshes_cmd(argv) -> int:
    """mergeMeshes <masterCase> <addCase>: concatenate the added
    mesh into the master's (reference: .../mergeMeshes/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("master")
    ap.add_argument("add")
    a = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from . import meshutils2

    m1 = mesh_io.read(os.path.join(a.master, "constant", "polyMesh"))
    m2 = mesh_io.read(os.path.join(a.add, "constant", "polyMesh"))
    out = meshutils2.merge_meshes(m1, m2)
    mesh_io.write(out, os.path.join(a.master, "constant", "polyMesh"))
    print(f"mergeMeshes: {out.n_cells} cells")
    return 0


def flatten_mesh_cmd(argv) -> int:
    """flattenMesh: flatten the empty-direction coordinates of a 2D
    mesh (reference: .../flattenMesh/)."""
    args = _case_arg(argv)
    from ..io import polymesh as mesh_io
    from . import meshutils2

    mdir = os.path.join(args.case, "constant", "polyMesh")
    out = meshutils2.flatten_mesh(mesh_io.read(mdir))
    mesh_io.write(out, mdir)
    print("flattenMesh: done")
    return 0


def auto_patch_cmd(argv) -> int:
    """autoPatch <featureAngle>: split the boundary by feature angle
    (reference: .../autoPatch/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("angle", type=float)
    ap.add_argument("-case", default=".")
    a = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from . import meshutils2

    mdir = os.path.join(a.case, "constant", "polyMesh")
    out = meshutils2.auto_patch(mesh_io.read(mdir), a.angle)
    mesh_io.write(out, mdir)
    print(f"autoPatch: {len(out.patches)} patches")
    return 0



def adiabatic_flame_t_cmd(argv) -> int:
    """adiabaticFlameT <controlFile>: flame temperature from janaf
    mixtures (reference: .../thermophysical/adiabaticFlameT/). The
    control file carries reactants/products mole-fraction dicts, T0,
    and the path of the species thermo dictionary."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("control")
    ap.add_argument("-case", default=".")
    a = ap.parse_args(argv)
    from ..core.dictionary import parse_file
    from . import thermoutils

    d = parse_file(a.control if os.path.exists(a.control)
                   else os.path.join(a.case, a.control))
    tpath = str(d.get("thermo", "constant/thermo.compressibleGas"))
    if not os.path.isabs(tpath):
        tpath = os.path.join(a.case, tpath)
    thermo = parse_file(tpath)
    T0 = float(d.get("T0", 300.0))
    reac = {str(k): float(v) for k, v in d["reactants"].items()}
    prod = {str(k): float(v) for k, v in d["products"].items()}
    T = thermoutils.adiabatic_flame_T(thermo, reac, prod, T0)
    print(f"Adiabatic flame temperature = {T:.2f} K")
    return 0


def mixture_adiabatic_flame_t_cmd(argv) -> int:
    """mixtureAdiabaticFlameT: as adiabaticFlameT with MASS-fraction
    composition (reference: .../mixtureAdiabaticFlameT/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("control")
    ap.add_argument("-case", default=".")
    a = ap.parse_args(argv)
    from ..core.dictionary import parse_file
    from . import thermoutils

    d = parse_file(a.control if os.path.exists(a.control)
                   else os.path.join(a.case, a.control))
    tpath = str(d.get("thermo", "constant/thermo.compressibleGas"))
    if not os.path.isabs(tpath):
        tpath = os.path.join(a.case, tpath)
    thermo = parse_file(tpath)
    reac = {str(k): float(v) for k, v in d["reactants"].items()}
    prod = {str(k): float(v) for k, v in d["products"].items()}
    T = thermoutils.adiabatic_flame_T(
        thermo, reac, prod, float(d.get("T0", 300.0)), by_mole=False)
    print(f"Adiabatic flame temperature = {T:.2f} K")
    return 0


def chemkin_to_foam_cmd(argv) -> int:
    """chemkinToFoam <CHEMKINFile> <thermoFile> <reactionsOut>
    <thermoOut> (reference: .../utilities/thermophysical/
    chemkinToFoam/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("chem")
    ap.add_argument("thermo")
    ap.add_argument("reactions_out")
    ap.add_argument("thermo_out")
    a = ap.parse_args(argv)
    from . import thermoutils

    n = thermoutils.chemkin_to_foam(a.chem, a.thermo, a.reactions_out,
                                    a.thermo_out)
    print(f"chemkinToFoam: {n} reactions")
    return 0



def sample_cmd(argv) -> int:
    """sample: run system/sampleDict sets/surfaces over saved times
    (reference: applications/utilities/postProcessing/sampling/
    sample/)."""
    args = _case_arg(argv)
    from ..core.case import Case
    from ..core.dictionary import FoamDict, parse_file
    from ..functionobjects.sampling import SampledSets
    from ..functionobjects.surfaces import SampledSurfaces

    case = Case(args.case)
    sd = parse_file(os.path.join(args.case, "system", "sampleDict"))

    def _entries(seq):
        # `sets ( name { ... } ... )` parses as alternating word/dict
        if seq is None or hasattr(seq, "items"):
            return seq
        out = FoamDict()
        lst = list(seq)
        i = 0
        while i < len(lst):
            if (i + 1 < len(lst) and hasattr(lst[i + 1], "get")
                    and not hasattr(lst[i], "get")):
                out[str(lst[i])] = lst[i + 1]
                i += 2
            else:
                out[f"set{i}"] = lst[i]
                i += 1
        return out

    fos = []
    if sd.get("sets") is not None:
        spec = FoamDict()
        spec["fields"] = sd.get("fields", ["U", "p"])
        spec["sets"] = _entries(sd["sets"])
        fos.append(SampledSets("sample", spec, case))
    if sd.get("surfaces") is not None:
        spec = FoamDict()
        spec["fields"] = sd.get("fields", ["U", "p"])
        spec["surfaces"] = _entries(sd["surfaces"])
        fos.append(SampledSurfaces("sampleSurfaces", spec, case))
    if not fos:
        print("sample: no sets/surfaces in sampleDict")
        return 1
    times = []
    for d in sorted(os.listdir(args.case)):
        try:
            float(d)
        except ValueError:
            continue
        if os.path.isdir(os.path.join(args.case, d)):
            times.append(d)
    n = 0
    for t in times:
        state = {}
        for fname in sorted(os.listdir(os.path.join(args.case, t))):
            base = fname[:-3] if fname.endswith(".gz") else fname
            try:
                state[base] = case.read_field(base, time=t)
            except Exception:
                continue
        if not state:
            continue
        for fo in fos:
            fo.execute(t, state)
        n += 1
        print(f"Time = {t}: sampled {sorted(state)}")
    print(f"sample: {n} times")
    return 0


def foam_to_ensight(argv) -> int:
    """foamToEnsight: EnSight Gold ASCII export of the mesh + saved
    fields (reference: applications/utilities/postProcessing/
    dataConversion/foamToEnsight/). Cells are written as `nfaced`
    polyhedra."""
    args = _case_arg(argv)
    import numpy as np

    from ..core.case import Case

    case = Case(args.case)
    pm = case.poly_mesh
    out = os.path.join(args.case, "EnSight")
    os.makedirs(out, exist_ok=True)

    # ---- geometry -----------------------------------------------------------
    cell_faces = [[] for _ in range(pm.n_cells)]
    nif = pm.n_internal_faces
    for f in range(pm.n_faces):
        cell_faces[pm.owner[f]].append((f, False))
        if f < nif:
            cell_faces[pm.neighbour[f]].append((f, True))
    with open(os.path.join(out, "geometry"), "w") as g:
        g.write("EnSight Geometry File\nwritten by foamtpu\n"
                "node id assign\nelement id assign\n"
                "part\n1\ninternalMesh\ncoordinates\n")
        g.write(f"{pm.n_points:10d}\n")
        for ax in range(3):
            g.write("\n".join(f"{x:12.5e}" for x in pm.points[:, ax])
                    + "\n")
        g.write(f"nfaced\n{pm.n_cells:10d}\n")
        for cf in cell_faces:
            g.write(f"{len(cf):10d}\n")
        for cf in cell_faces:
            for f, flip in cf:
                g.write(f"{int(pm.face_npts[f]):10d}\n")
        for cf in cell_faces:
            for f, flip in cf:
                pts = list(pm.face_pts[f, :pm.face_npts[f]])
                if flip:
                    pts = pts[::-1]
                g.write(" ".join(str(p + 1) for p in pts) + "\n")

    # ---- per-time variables ---------------------------------------------------
    times = []
    for d in sorted(os.listdir(args.case), key=lambda s: (len(s), s)):
        try:
            float(d)
        except ValueError:
            continue
        if os.path.isdir(os.path.join(args.case, d)):
            times.append(d)
    times.sort(key=float)
    var_names = {}
    for ti, t in enumerate(times):
        for fname in sorted(os.listdir(os.path.join(args.case, t))):
            base = fname[:-3] if fname.endswith(".gz") else fname
            try:
                f = case.read_field(base, time=t)
            except Exception:
                continue
            data = np.asarray(f.data)
            kind = "vector" if data.ndim == 2 else "scalar"
            var_names[base] = kind
            with open(os.path.join(out, f"{base}.{ti:04d}"),
                      "w") as vf:
                vf.write(f"{base}\npart\n1\nnfaced\n")
                if data.ndim == 1:
                    vf.write("\n".join(f"{x:12.5e}" for x in data)
                             + "\n")
                else:
                    for ax in range(3):
                        vf.write("\n".join(f"{x:12.5e}"
                                            for x in data[:, ax])
                                 + "\n")
    with open(os.path.join(out, "case.case"), "w") as cf:
        cf.write("FORMAT\ntype: ensight gold\n\nGEOMETRY\n"
                 "model: geometry\n\nVARIABLE\n")
        for name, kind in var_names.items():
            cf.write(f"{kind} per element: {name} {name}.****\n")
        cf.write(f"\nTIME\ntime set: 1\nnumber of steps: "
                 f"{len(times)}\nfilename start number: 0\n"
                 f"filename increment: 1\ntime values:\n")
        cf.write("\n".join(t for t in times) + "\n")
    print(f"foamToEnsight: {len(times)} times, "
          f"{len(var_names)} fields -> {out}")
    return 0



def surface_check(argv) -> int:
    """surfaceCheck <surface.stl>: triangle quality/closedness report
    (reference: applications/utilities/surface/surfaceCheck/)."""
    import argparse as _ap

    import numpy as np

    ap = _ap.ArgumentParser()
    ap.add_argument("surf")
    a = ap.parse_args(argv)
    from ..mesh.snappy import read_stl

    tris = read_stl(a.surf)
    n = tris.shape[0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    degenerate = int((areas < 1e-30).sum())
    # closedness: every edge shared by exactly 2 triangles
    pts = tris.reshape(-1, 3)
    _, inv = np.unique(np.round(pts, 10), axis=0, return_inverse=True)
    tri_pts = inv.reshape(-1, 3)
    edges = {}
    for t in tri_pts:
        for i in range(3):
            e = tuple(sorted((int(t[i]), int(t[(i + 1) % 3]))))
            edges[e] = edges.get(e, 0) + 1
    open_edges = sum(1 for v in edges.values() if v != 2)
    bb = (tris.reshape(-1, 3).min(axis=0),
          tris.reshape(-1, 3).max(axis=0))
    print(f"Triangles      : {n}")
    print(f"Bounding box   : ({bb[0][0]:g} {bb[0][1]:g} {bb[0][2]:g}) "
          f"({bb[1][0]:g} {bb[1][1]:g} {bb[1][2]:g})")
    print(f"Total area     : {areas.sum():g}")
    print(f"Degenerate tris: {degenerate}")
    print(f"Open edges     : {open_edges} "
          f"({'closed' if open_edges == 0 else 'OPEN'} surface)")
    return 0


def surface_convert(argv) -> int:
    """surfaceConvert <in> <out>: STL <-> OBJ/VTK conversion
    (reference: applications/utilities/surface/surfaceConvert/)."""
    import argparse as _ap

    import numpy as np

    ap = _ap.ArgumentParser()
    ap.add_argument("infile")
    ap.add_argument("outfile")
    a = ap.parse_args(argv)
    from ..mesh.snappy import read_stl, write_stl

    ext_in = os.path.splitext(a.infile)[1].lower()
    if ext_in in (".stl", ".stlb"):
        tris = read_stl(a.infile)
    elif ext_in == ".obj":
        vs, fs = [], []
        for ln in open(a.infile):
            t = ln.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                fs.append([int(x.split("/")[0]) - 1 for x in t[1:4]])
        v = np.asarray(vs)
        tris = v[np.asarray(fs)]
    else:
        print(f"surfaceConvert: unsupported input {ext_in}")
        return 1
    ext = os.path.splitext(a.outfile)[1].lower()
    if ext == ".obj":
        pts = tris.reshape(-1, 3)
        upts, inv = np.unique(np.round(pts, 10), axis=0,
                              return_inverse=True)
        with open(a.outfile, "w") as f:
            f.write("# written by foamtpu surfaceConvert\n")
            for p in upts:
                f.write(f"v {p[0]:g} {p[1]:g} {p[2]:g}\n")
            for t in inv.reshape(-1, 3):
                f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    elif ext in (".stl", ".stlb"):
        write_stl(a.outfile, tris)
    elif ext == ".vtk":
        pts = tris.reshape(-1, 3)
        upts, inv = np.unique(np.round(pts, 10), axis=0,
                              return_inverse=True)
        with open(a.outfile, "w") as f:
            f.write("# vtk DataFile Version 2.0\nsurface\nASCII\n"
                    "DATASET POLYDATA\n")
            f.write(f"POINTS {len(upts)} float\n")
            for p in upts:
                f.write(f"{p[0]:g} {p[1]:g} {p[2]:g}\n")
            t = inv.reshape(-1, 3)
            f.write(f"POLYGONS {len(t)} {4 * len(t)}\n")
            for a3 in t:
                f.write(f"3 {a3[0]} {a3[1]} {a3[2]}\n")
    else:
        print(f"surfaceConvert: unsupported output {ext}")
        return 1
    print(f"surfaceConvert: {tris.shape[0]} triangles -> {a.outfile}")
    return 0


def surface_transform_points(argv) -> int:
    """surfaceTransformPoints -translate/-scale/-rollPitchYaw <in>
    <out> (reference: .../surface/surfaceTransformPoints/)."""
    import argparse as _ap

    import numpy as np

    ap = _ap.ArgumentParser()
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("-translate", default=None)
    ap.add_argument("-scale", default=None)
    ap.add_argument("-rollPitchYaw", default=None)
    a = ap.parse_args(argv)
    from ..mesh.snappy import read_stl, write_stl

    tris = read_stl(a.infile)

    def vec(s):
        return np.asarray([float(x) for x in
                           s.strip("() ").split()], float)

    if a.scale:
        tris = tris * vec(a.scale)[None, None, :]
    if a.rollPitchYaw:
        r, p, y = np.deg2rad(vec(a.rollPitchYaw))
        cx, sx = np.cos(r), np.sin(r)
        cy, sy = np.cos(p), np.sin(p)
        cz, sz = np.cos(y), np.sin(y)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        R = Rz @ Ry @ Rx
        tris = tris @ R.T
    if a.translate:
        tris = tris + vec(a.translate)[None, None, :]
    write_stl(a.outfile, tris)
    print(f"surfaceTransformPoints: {tris.shape[0]} triangles")
    return 0



def tutorials_cmd(argv) -> int:
    """tutorials [-test] [-filter substr] [-steps N]: the Alltest
    tutorial-regression harness (reference: tutorials/Alltest +
    bin/tools/RunFunctions). Each discovered case is copied to a
    scratch directory and driven through its pipeline: an explicit
    per-case Allrun (runApplication lines) when present, else
    blockMesh -> topoSet/setFields (if their dicts exist) -> run.
    -test caps every solver at -steps N (default 3), the reference
    Alltest's controlDict-shortening analogue."""
    import argparse as _ap
    import shutil
    import tempfile
    import time as _time
    import traceback

    ap = _ap.ArgumentParser()
    ap.add_argument("-test", action="store_true")
    ap.add_argument("-filter", default="")
    ap.add_argument("-steps", type=int, default=3)
    ap.add_argument("-root", default="tutorials")
    a = ap.parse_args(argv)

    cases = []
    for root, dirs, files in os.walk(a.root):
        if (os.path.basename(root) == "system"
                and "controlDict" in files):
            cases.append(os.path.dirname(root))
    cases.sort()
    if a.filter:
        cases = [c for c in cases if a.filter in c]
    if not cases:
        print("tutorials: no cases found")
        return 1

    results = []
    for src in cases:
        name = os.path.relpath(src, a.root)
        t0 = _time.time()
        tmp = tempfile.mkdtemp(prefix="foamtpu-tut-")
        case = os.path.join(tmp, os.path.basename(src))
        shutil.copytree(src, case)
        ok, msg = True, ""
        try:
            allrun = os.path.join(case, "Allrun")
            steps = ["blockMesh"]
            if os.path.exists(allrun):
                steps = []
                for ln in open(allrun):
                    ln = ln.strip()
                    if ln.startswith(("runApplication",
                                      "runParallel")):
                        steps.append(" ".join(ln.split()[1:]))
            else:
                sysd = os.path.join(case, "system")
                if os.path.exists(os.path.join(sysd,
                                               "topoSetDict")):
                    steps.append("topoSet")
                if os.path.exists(os.path.join(
                        sysd, "snappyHexMeshDict")):
                    steps.append("snappyHexMesh")
                if os.path.exists(os.path.join(sysd,
                                               "setFieldsDict")):
                    steps.append("setFields")
                steps.append("run")
            for st in steps:
                argv2 = st.split()
                cmd0 = argv2[0]
                rest = argv2[1:]
                if cmd0 not in COMMANDS:
                    # a solver name: route through run
                    cmd0, rest = "run", []
                args2 = rest + ["-case", case]
                if a.test and cmd0 == "run":
                    args2 += ["-steps", str(a.steps)]
                rc = COMMANDS[cmd0](args2)
                if rc != 0:
                    ok, msg = False, f"{cmd0} rc={rc}"
                    break
        except Exception as e:      # noqa: BLE001 - harness boundary
            ok = False
            msg = f"{type(e).__name__}: {e}"
            if os.environ.get("FOAMTPU_DEBUG"):
                traceback.print_exc()
        dt = _time.time() - t0
        results.append((name, ok, dt, msg))
        print(f"{'PASS' if ok else 'FAIL'}  {name}  ({dt:.1f}s)"
              + (f"  {msg}" if msg else ""))
        shutil.rmtree(tmp, ignore_errors=True)
    n_fail = sum(1 for _, ok, _, _ in results if not ok)
    print(f"\ntutorials: {len(results) - n_fail}/{len(results)} "
          f"passed")
    return 1 if n_fail else 0



def fluent_mesh_to_foam(argv) -> int:
    """fluentMeshToFoam <mesh.msh>: convert an ASCII Fluent mesh
    (reference: .../mesh/conversion/fluentMeshToFoam/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("mshfile")
    ap.add_argument("-case", default=".")
    a = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from .fluent import read_fluent

    pm = read_fluent(a.mshfile)
    mdir = os.path.join(a.case, "constant", "polyMesh")
    os.makedirs(mdir, exist_ok=True)
    mesh_io.write(pm, mdir)
    print(f"fluentMeshToFoam: {pm.n_cells} cells, {pm.n_faces} faces, "
          f"{len(pm.patches)} patches")
    return 0


def create_baffles_cmd(argv) -> int:
    """createBaffles: faceSet internal faces -> twin baffle patches
    (reference: applications/utilities/mesh/manipulation/
    createBaffles/)."""
    args = _case_arg(argv)
    from . import meshutils3

    out = meshutils3.create_baffles_cmd(args.case)
    print(f"createBaffles: patches now "
          f"{[(p.name, p.size) for p in out.patches]}")
    return 0


def sets_to_zones_cmd(argv) -> int:
    """setsToZones: promote saved cellSets to cellZones (reference:
    .../mesh/manipulation/setsToZones/)."""
    args = _case_arg(argv)
    from . import meshutils3

    names = meshutils3.sets_to_zones(args.case)
    print(f"setsToZones: promoted {names}")
    return 0


def foam_format_convert_cmd(argv) -> int:
    """foamFormatConvert [-format ascii|binary] [-time t]: rewrite a
    time directory's fields (reference: .../miscellaneous/
    foamFormatConvert/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-format", dest="fmt", default="binary",
                    choices=["ascii", "binary"])
    ap.add_argument("-time", default=None)
    a = ap.parse_args(argv)
    from . import meshutils3

    done = meshutils3.foam_format_convert(a.case, a.fmt, a.time)
    print(f"foamFormatConvert: rewrote {done} as {a.fmt}")
    return 0


def deformed_geom_cmd(argv) -> int:
    """deformedGeom <scale>: displace mesh points by the
    point-interpolated U * scale (reference: .../mesh/manipulation/
    deformedGeom/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("scale", type=float)
    ap.add_argument("-case", default=".")
    ap.add_argument("-time", default=None)
    a = ap.parse_args(argv)
    from . import meshutils3

    meshutils3.deformed_geom(a.case, a.scale, a.time)
    print(f"deformedGeom: points displaced by {a.scale} * U")
    return 0


def post_channel_cmd(argv) -> int:
    """postChannel: collapse U to wall-normal mean/rms profiles
    (reference: .../postProcessing/channel/postChannel/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-time", default=None)
    ap.add_argument("-normal", type=int, default=1)
    a = ap.parse_args(argv)
    from . import meshutils3

    path = meshutils3.post_channel(a.case, a.time, a.normal)
    print(f"postChannel: wrote {path}")
    return 0


def netgen_to_foam_cmd(argv) -> int:
    """netgenNeutralToFoam <file>: Netgen neutral tet mesh ->
    polyMesh (reference: .../mesh/conversion/netgenNeutralToFoam/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("neuFile")
    ap.add_argument("-case", default=".")
    a = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from ..mesh import gmsh

    pm = gmsh.convert_netgen(a.neuFile)
    out = os.path.join(a.case, "constant", "polyMesh")
    mesh_io.write(pm, out)
    print(f"netgenNeutralToFoam: {pm.n_cells} cells, {pm.n_faces} "
          f"faces, patches {[p.name for p in pm.patches]}")
    return 0


def write_mesh_obj_cmd(argv) -> int:
    """writeMeshObj: dump the mesh (boundary faces) as a Wavefront
    OBJ for external inspection (reference: .../mesh/manipulation/
    writeMeshObj/)."""
    args = _case_arg(argv)
    from ..io import polymesh as mesh_io

    pm = mesh_io.read(os.path.join(args.case, "constant", "polyMesh"))
    out = os.path.join(args.case, "meshBoundary.obj")
    with open(out, "w") as f:
        f.write("# foamtpu writeMeshObj\n")
        for p in pm.points:
            f.write(f"v {p[0]:.8g} {p[1]:.8g} {p[2]:.8g}\n")
        nif = pm.n_internal_faces
        for fi in range(nif, pm.n_faces):
            k = pm.face_npts[fi]
            idx = " ".join(str(int(x) + 1)
                           for x in pm.face_pts[fi, :k])
            f.write(f"f {idx}\n")
    print(f"writeMeshObj: wrote {pm.n_faces - pm.n_internal_faces} "
          f"boundary faces -> {out}")
    return 0


def foam_debug_switches_cmd(argv) -> int:
    """foamDebugSwitches: list the DebugSwitches gates the framework
    honours (reference: applications/utilities/miscellaneous/
    foamDebugSwitches/)."""
    from ..utils import logging as log_mod

    known = sorted(getattr(log_mod, "KNOWN_DEBUG_SWITCHES",
                           ["lduMatrix", "GAMG", "blockMesh",
                            "polyMesh", "fvSchemes", "time"]))
    active = [k for k in known if log_mod.debug(k)]
    print("DebugSwitches honoured (set via controlDict DebugSwitches"
          " {} or FOAMTPU_DEBUG=<name,...>):")
    for k in known:
        print(f"    {k:16s} {'ON' if k in active else 'off'}")
    return 0


def particle_tracks_cmd(argv) -> int:
    """particleTracks: join each parcel's positions across saved
    times into polylines, written as legacy-VTK (reference:
    applications/utilities/postProcessing/lagrangian/particleTracks/).
    Parcels are correlated by the origId written next to positions."""
    import argparse as _ap
    import re as _re

    ap = _ap.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-cloud", default="kinematicCloud")
    a = ap.parse_args(argv)
    times = []
    for dname in os.listdir(a.case):
        try:
            tval = float(dname)
        except ValueError:
            continue
        if os.path.isdir(os.path.join(a.case, dname)):
            times.append((tval, dname))
    times = [d for _, d in sorted(times)]
    tracks = {}
    for t in times:
        d = os.path.join(a.case, t, "lagrangian", a.cloud)
        ppath = os.path.join(d, "positions")
        if not os.path.exists(ppath):
            continue
        txt = open(ppath).read()
        pts = [[float(x) for x in m.groups()]
               for m in _re.finditer(
                   r"\(([-\d.eE+]+)\s+([-\d.eE+]+)\s+([-\d.eE+]+)\)",
                   txt)]
        idpath = os.path.join(d, "origId")
        if os.path.exists(idpath):
            ids = [int(x) for x in _re.findall(
                r"^\s*(\d+)\s*$", open(idpath).read(), _re.M)]
            if len(ids) == len(pts) + 1:   # first match is the count
                ids = ids[1:]
        else:
            ids = list(range(len(pts)))
        for i, p in zip(ids, pts):
            tracks.setdefault(i, []).append(p)
    tracks = {i: p for i, p in tracks.items() if len(p) >= 2}
    if not tracks:
        print("particleTracks: no parcel positions found",
              file=sys.stderr)
        return 1
    out_dir = os.path.join(a.case, "postProcessing", "particleTracks")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "tracks.vtk")
    pts_all, lines = [], []
    for i in sorted(tracks):
        start = len(pts_all)
        pts_all.extend(tracks[i])
        lines.append(list(range(start, len(pts_all))))
    with open(out, "w") as f:
        f.write("# vtk DataFile Version 2.0\nparticleTracks\nASCII\n"
                "DATASET POLYDATA\n")
        f.write(f"POINTS {len(pts_all)} float\n")
        for p in pts_all:
            f.write(f"{p[0]:g} {p[1]:g} {p[2]:g}\n")
        total = sum(len(l) + 1 for l in lines)
        f.write(f"LINES {len(lines)} {total}\n")
        for l in lines:
            f.write(str(len(l)) + " " + " ".join(map(str, l)) + "\n")
    print(f"particleTracks: {len(lines)} tracks, {len(pts_all)} "
          f"points -> {out}")
    return 0


def set_set_cmd(argv) -> int:
    """setSet -batch <file>: scripted set creation (reference:
    applications/utilities/mesh/manipulation/setSet/). Lines:
      cellSet <name> new boxToCell (x0 y0 z0) (x1 y1 z1)
      faceSet <name> new boxToFace (..) (..)
      cellSet <name> add|delete|subtract ... / invert"""
    import argparse as _ap
    import re as _re

    ap = _ap.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-batch", required=True)
    a = ap.parse_args(argv)
    from ..core.dictionary import FoamDict
    from ..io import polymesh as mesh_io
    from . import meshutils

    pm = mesh_io.read(os.path.join(a.case, "constant", "polyMesh"))
    current = {}
    count = 0
    for ln in open(a.batch):
        ln = ln.split("//")[0].strip()
        if not ln or ln in ("quit", "q"):
            continue
        toks = ln.split()
        if len(toks) < 3:
            continue
        kind, name, action = toks[0], toks[1], toks[2]
        if action == "invert":
            n = pm.n_cells if kind == "cellSet" else pm.n_faces
            prev = current.get(name, np.zeros(0, np.int64))
            current[name] = np.setdiff1d(np.arange(n), prev)
        else:
            source = toks[3] if len(toks) > 3 else ""
            nums = [float(x) for x in _re.findall(
                r"[-+0-9.eE]+", " ".join(toks[4:]))]
            info = FoamDict()
            if "box" in source.lower():
                info["box"] = np.asarray(nums[:6]).reshape(2, 3)
            elif "sphere" in source.lower():
                info["centre"] = np.asarray(nums[:3])
                info["radius"] = nums[3]
            ids = (meshutils._source_cells(pm, source, info)
                   if kind == "cellSet"
                   else meshutils._source_faces(pm, source, info))
            prev = current.get(name, np.zeros(0, np.int64))
            if action == "new":
                current[name] = ids
            elif action == "add":
                current[name] = np.union1d(prev, ids)
            elif action in ("delete", "subtract"):
                current[name] = np.setdiff1d(prev, ids)
        meshutils.write_set(a.case, name, kind, current[name])
        count += 1
        print(f"setSet: {kind} {name} -> {current[name].size} entries")
    print(f"setSet: executed {count} commands")
    return 0


def stitch_mesh_cmd(argv) -> int:
    """stitchMesh <master> <slave>: merge two coincident boundary
    patches into internal faces (reference: .../mesh/manipulation/
    stitchMesh/, perfect-match mode)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("master")
    ap.add_argument("slave")
    ap.add_argument("-case", default=".")
    ap.add_argument("-tol", type=float, default=1e-7)
    a = ap.parse_args(argv)
    from ..io import polymesh as mesh_io
    from . import meshutils3

    mdir = os.path.join(a.case, "constant", "polyMesh")
    pm = mesh_io.read(mdir)
    out = meshutils3.stitch_mesh(pm, a.master, a.slave, a.tol)
    mesh_io.write(out, mdir)
    print(f"stitchMesh: merged {a.master}/{a.slave}; "
          f"{out.n_internal_faces} internal faces, patches "
          f"{[p.name for p in out.patches]}")
    return 0


def temporal_interpolate_cmd(argv) -> int:
    """temporalInterpolate -time t -fields '(U p)': linear field
    interpolation between the bracketing saved times (reference:
    .../postProcessing/miscellaneous/temporalInterpolate/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("-case", default=".")
    ap.add_argument("-time", type=float, required=True)
    ap.add_argument("-fields", default="U p")
    a = ap.parse_args(argv)
    from . import meshutils3

    names = [x for x in a.fields.replace("(", " ").replace(")", " ")
             .split() if x]
    done = meshutils3.temporal_interpolate(a.case, a.time, names)
    print(f"temporalInterpolate: wrote {done} at t={a.time:g}")
    return 0


def write_cell_volumes(argv) -> int:
    """writeCellVolumes (reference: .../postProcessing/miscellaneous/
    writeCellVolumes/)."""
    args = _case_arg(argv)
    import jax.numpy as jnp

    from ..core.case import Case
    from ..core.dimensions import DimensionSet
    from ..core.fields import vol_scalar
    from ..io import fields as field_io

    case = Case(args.case)
    mesh = case.mesh
    t = args.time or case.latest_time_name()
    out = vol_scalar(mesh, 0.0, name="V",
                     dims=DimensionSet.of(0, 3, 0)).with_data(
        jnp.asarray(mesh.v))
    field_io.write_field(out, mesh, case.dir, t)
    print(f"writeCellVolumes: wrote V at {t} "
          f"(total {float(jnp.sum(mesh.v)):.6g} m^3)")
    return 0


def surface_subset(argv) -> int:
    """surfaceSubset <in> <out> -box 'x0 y0 z0 x1 y1 z1': keep the
    triangles whose centroid is inside the box (reference:
    applications/utilities/surface/surfaceSubset/)."""
    import argparse as _ap

    ap = _ap.ArgumentParser()
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("-box", required=True)
    a = ap.parse_args(argv)
    from ..mesh.snappy import read_stl, write_stl

    vals = [float(x) for x in a.box.replace("(", " ")
            .replace(")", " ").split()]
    lo, hi = np.asarray(vals[:3]), np.asarray(vals[3:6])
    tris = read_stl(a.infile)
    c = tris.mean(axis=1)
    keep = np.all((c >= lo) & (c <= hi), axis=1)
    write_stl(a.outfile, tris[keep])
    print(f"surfaceSubset: kept {int(keep.sum())}/{len(tris)} "
          f"triangles -> {a.outfile}")
    return 0


COMMANDS = {
    "blockMesh": block_mesh,
    "particleTracks": particle_tracks_cmd,
    "stitchMesh": stitch_mesh_cmd,
    "temporalInterpolate": temporal_interpolate_cmd,
    "writeCellVolumes": write_cell_volumes,
    "surfaceSubset": surface_subset,
    "setSet": set_set_cmd,
    "netgenNeutralToFoam": netgen_to_foam_cmd,
    "writeMeshObj": write_mesh_obj_cmd,
    "foamDebugSwitches": foam_debug_switches_cmd,
    "snappyHexMesh": snappy_hex_mesh,
    "topoSet": topo_set_cmd,
    "createPatch": create_patch_cmd,
    "extrudeMesh": extrude_mesh_cmd,
    "refineMesh": refine_mesh_cmd,
    "mirrorMesh": mirror_mesh_cmd,
    "subsetMesh": subset_mesh_cmd,
    "mergeMeshes": merge_meshes_cmd,
    "flattenMesh": flatten_mesh_cmd,
    "autoPatch": auto_patch_cmd,
    "adiabaticFlameT": adiabatic_flame_t_cmd,
    "mixtureAdiabaticFlameT": mixture_adiabatic_flame_t_cmd,
    "chemkinToFoam": chemkin_to_foam_cmd,
    "sample": sample_cmd,
    "foamToEnsight": foam_to_ensight,
    "surfaceCheck": surface_check,
    "surfaceConvert": surface_convert,
    "surfaceTransformPoints": surface_transform_points,
    "tutorials": tutorials_cmd,
    "changeDictionary": change_dictionary_cmd,
    "gmshToFoam": gmsh_to_foam_cmd,
    "fluentMeshToFoam": fluent_mesh_to_foam,
    "splitMeshRegions": split_mesh_regions_cmd,
    "postProcess": post_process,
    "execFlowFunctionObjects": post_process,
    "renumberMesh": renumber_mesh,
    "checkMesh": check_mesh,
    "run": run,
    "decomposePar": decompose_par,
    "foamToVTK": foam_to_vtk,
    "setFields": set_fields,
    "boxTurb": box_turb,
    "foamListTimes": foam_list_times,
    "transformPoints": transform_points,
    "mapFields": map_fields,
    "patchAverage": patch_average,
    "foamCalc": foam_calc,
    "writeCellCentres": write_cell_centres,
    "createBaffles": create_baffles_cmd,
    "setsToZones": sets_to_zones_cmd,
    "foamFormatConvert": foam_format_convert_cmd,
    "deformedGeom": deformed_geom_cmd,
    "postChannel": post_channel_cmd,
    "objToVTK": surface_convert,
}

from . import postutils as _postutils  # noqa: E402

COMMANDS.update(_postutils.COMMANDS)

from . import meshutils4 as _meshutils4  # noqa: E402

COMMANDS.update(_meshutils4.COMMANDS)

from . import meshutils5 as _meshutils5  # noqa: E402

COMMANDS.update(_meshutils5.COMMANDS)

from . import preputils as _preputils  # noqa: E402

COMMANDS.update(_preputils.COMMANDS)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    import jax

    from ..core import compile_cache

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    compile_cache.configure()
    cmd = argv[0]
    # allow `python -m foamtpu icoFoam -case ...` style too
    if cmd not in COMMANDS:
        from ..core.case import run_case, Case

        args = _case_arg(argv[1:])
        case = Case(args.case)
        if case.application == cmd or cmd in ("icoFoam",):
            run_case(args.case, max_steps=args.steps)
            return 0
        print(f"unknown command {cmd!r}; available: {sorted(COMMANDS)}",
              file=sys.stderr)
        return 1
    return COMMANDS[cmd](argv[1:])
