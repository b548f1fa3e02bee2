"""End-to-end case pipeline: unmodified OpenFOAM case files ->
blockMesh -> icoFoam -> OpenFOAM-format output (the north-star
'tutorial cases run unmodified' requirement)."""

import os
import shutil

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAVITY = os.path.join(REPO, "tutorials", "incompressible", "icoFoam", "cavity")


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cavity")
    dst = os.path.join(d, "cavity")
    shutil.copytree(CAVITY, dst)
    return dst


def test_blockmesh_cli(case_dir):
    from foamtpu.apps.cli import main

    assert main(["blockMesh", "-case", case_dir]) == 0
    assert os.path.exists(os.path.join(case_dir, "constant/polyMesh/points"))
    assert main(["checkMesh", "-case", case_dir]) == 0


def test_polymesh_roundtrip(case_dir):
    from foamtpu.io import polymesh as mesh_io
    from foamtpu.mesh.check import check

    m = mesh_io.read(os.path.join(case_dir, "constant", "polyMesh"))
    assert m.n_cells == 400
    stats = check(m)
    np.testing.assert_allclose(stats["totalVolume"], 1e-4, rtol=1e-9)
    # write + re-read identical topology
    out = os.path.join(case_dir, "constant", "polyMesh2")
    mesh_io.write(m, out)
    m2 = mesh_io.read(out)
    np.testing.assert_array_equal(m.owner, m2.owner)
    np.testing.assert_array_equal(m.neighbour, m2.neighbour)
    np.testing.assert_allclose(m.points, m2.points, atol=1e-12)
    assert [p.name for p in m.patches] == [p.name for p in m2.patches]


def test_field_reading(case_dir):
    from foamtpu.core.case import Case

    case = Case(case_dir)
    U = case.read_field("U")
    p = case.read_field("p")
    assert U.data.shape == (400, 3)
    assert p.data.shape == (400,)
    # BC types from the files
    kinds = {patch.name: bc.kind for patch, bc in zip(case.mesh.patches, U.bcs)}
    assert kinds["movingWall"] == "fixedValue"
    assert kinds["frontAndBack"] == "empty"
    bv = np.asarray(U.bcs[0].ref_value)
    np.testing.assert_allclose(bv[0], [1.0, 0.0, 0.0])


def test_icofoam_case_run(case_dir, capsys):
    from foamtpu.core.case import run_case

    case = run_case(case_dir, max_steps=10)
    out = capsys.readouterr().out
    # reference-format log lines (foamLog-parsable)
    assert "Courant Number mean" in out
    assert "Solving for Ux, Initial residual" in out
    assert "Solving for p, Initial residual" in out
    assert "time step continuity errors" in out
    # output fields written and re-readable
    tname = case.time.name
    path = os.path.join(case_dir, tname, "U")
    assert os.path.exists(path)
    U2 = case.read_field("U", time=tname)
    u = np.asarray(U2.data)
    assert np.abs(u).max() <= 1.0 + 1e-3
    assert np.abs(u[:, 2]).max() < 1e-6


def test_decompose_and_vtk(case_dir):
    from foamtpu.apps.cli import main

    assert main(["decomposePar", "-case", case_dir]) == 0
    assert main(["foamToVTK", "-case", case_dir]) == 0
    vtks = os.listdir(os.path.join(case_dir, "VTK"))
    assert any(v.endswith(".vtk") for v in vtks)


def test_vtk_fields_from_long_time_name(tmp_path):
    """foamToVTK finds the latest time directory by the name the solver
    wrote (controlDict timePrecision), not a 6-digit reformatting of it."""
    from foamtpu.apps.cli import main

    case = str(tmp_path / "cavity")
    shutil.copytree(CAVITY, case)
    ctl = os.path.join(case, "system", "controlDict")
    with open(ctl) as f:
        text = f.read()
    with open(ctl, "w") as f:
        f.write(text.replace("timePrecision   6;", "timePrecision   10;"))
    assert main(["blockMesh", "-case", case]) == 0
    shutil.copytree(os.path.join(case, "0"),
                    os.path.join(case, "0.02083333333"))
    assert main(["foamToVTK", "-case", case]) == 0
    out = os.path.join(case, "VTK", "cavity_0.02083333333.vtk")
    with open(out) as f:
        heads = {ln.split()[1] for ln in f
                 if ln.startswith(("SCALARS ", "VECTORS "))}
    assert {"U", "p"} <= heads
