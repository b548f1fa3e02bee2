"""chip_smoke.py pieces that run without a card: the cube case it
generates is accepted by blockMesh and run on the CPU, the field reader
reads what the solver wrote, the four-card phase passes on virtual CPU
devices, and the script refuses to report anything when JAX finds no
GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np

import chip_smoke
from foamtpu.apps.cli import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cube_case_runs_on_cpu(tmp_path):
    case = str(tmp_path / "cube")
    dt = chip_smoke.make_cube_case(case, 8, 2, subdomains=4)
    assert abs(dt - 0.5 * 0.1 / 8) < 1e-15
    assert os.path.exists(os.path.join(case, "system", "decomposeParDict"))
    assert cli_main(["blockMesh", "-case", case]) == 0
    assert cli_main(["run", "-case", case, "-steps", "2"]) == 0
    fields = chip_smoke.final_fields(case, 8 ** 3)
    assert fields["U"].shape == (512, 3) and fields["p"].shape == (512,)
    assert np.isfinite(fields["U"]).all() and np.isfinite(fields["p"]).all()
    assert np.max(np.linalg.norm(fields["U"], axis=1)) <= chip_smoke.U_BOUND
    tdir = chip_smoke.latest_time_dir(case)
    assert abs(float(os.path.basename(tdir)) - 2 * dt) < 1e-12


def test_refuses_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                        "--work", str(tmp_path / "work")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def test_multi_rehearsal_on_virtual_cpu_devices(tmp_path):
    """`--multi --rehearse`: the four-card phase on four virtual CPU
    devices at toy size, both halo paths checked against one device."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                        "--multi", "--rehearse", "--work",
                        str(tmp_path / "work")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [json.loads(ln) for ln in r.stdout.splitlines()]
    multi = lines[-1]
    assert multi["phase"] == "multi" and multi["ok"]
    assert multi["gspmd"]["spread"] == {"devices": 4, "halo": "gspmd"}
    assert multi["explicit"]["spread"] == {"devices": 4, "halo": "explicit"}
    for name in ("gspmd", "explicit"):
        for k in ("U", "p"):
            assert multi[f"{name}_max_abs_d{k}"] < chip_smoke.PARITY_F64
    assert not any(ln.get("ok") is True and "device" in ln
                   and "phase" not in ln for ln in lines)
