#!/usr/bin/env python3
"""Smoke run of foamtpu's solver path on an NVIDIA GPU.

    python chip_smoke.py              # phases a-e on one card
    python chip_smoke.py --multi      # `run -parallel` on four cards only
    python chip_smoke.py --rehearse   # the same path on the CPU, toy sizes

Phases, each reported as one JSON line on stdout:

  a. device     A child process confirms that JAX sees a GPU. GPU children
                run with JAX_PLATFORMS=cuda, so a CUDA start-up failure is
                an error and never a silent CPU run.
  b. cube       100^3 lid-driven cube (the icoFoam cavity tutorial made
                three-dimensional: frontAndBack a no-slip wall, z extent
                equal to x and y), PISO with 2 correctors, p by GAMG,
                Courant ~0.5, 20 steps, through `python -m foamtpu`.
  c. pitzDaily  the simpleFoam tutorial (kEpsilon, wall functions, GAMG),
                100 SIMPLE iterations through the CLI. The log shows every
                10th iteration; p's initial residual must fall from the
                first logged value to the last (it rises over the first
                ~40 iterations before it falls).
  d. parity     a 48^3 cube for 10 steps, run on the GPU in f32 and in f64
                and on the CPU in f64 (the reference); final U and p
                compared.
  e. kernels    StencilOp.matvec at 1M cells against a float64 scipy CSR
                product, and the GAMG coarsest dense solve at n = 1024,
                whose residual bound a TF32 contraction would fail.

Phases b-d run the CLI as child processes, one at a time; this process
opens the GPU only in phase e, after every child has exited, so one process
holds the card at a time. Any failed check makes the exit code non-zero.
The last line, `{"ok": true, "device": {...}}`, is printed only when every
phase passed on a GPU.

With --multi the script runs only the sharded path: the 100^3 cube for 10
steps in f64 through `run -parallel` on 4 cards, once with the GSPMD halo
and once with FOAMTPU_HALO=explicit, each compared with a one-card run.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CAVITY = os.path.join(REPO, "tutorials", "incompressible", "icoFoam",
                      "cavity")
PITZ = os.path.join(REPO, "tutorials", "incompressible", "simpleFoam",
                    "pitzDaily")

# Bounds, with their reasons:
# - GPU f64 vs CPU f64: only summation order and atomics differ, amplified
#   through the 1e-6 pressure tolerance; the repo's sharded-vs-single f64
#   check uses the same bound.
# - GPU f32 vs CPU f64: f32 stopping noise of the pressure solve.
PARITY_F64 = 1e-4
PARITY_F32 = 5e-3
CONTINUITY_MAX = 1e-4
LID_SPEED = 1.0
U_BOUND = 1.05 * LID_SPEED
MATVEC_RTOL = 1e-5
SIMPLE_CHUNK = 10             # iterations per simpleFoam log line
COARSE_RTOL = 1e-4

FULL = dict(cube_n=100, cube_steps=20, pitz_iters=100, parity_n=48,
            parity_steps=10, matvec_n=1_000_000, matvec_deltas=(1, 100,
                                                                10_000),
            multi_n=100, multi_steps=10, child_timeout=900)
TOY = dict(cube_n=10, cube_steps=3, pitz_iters=100, parity_n=8,
           parity_steps=3, matvec_n=100_000, matvec_deltas=(1, 40, 1600),
           multi_n=8, multi_steps=3, child_timeout=600)


class PhaseFailed(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# case generation
# ---------------------------------------------------------------------------


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"case template changed: {old!r} not found")
    return text.replace(old, new)


def _patch_file(path: str, edits) -> None:
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        text = _sub(text, old, new)
    with open(path, "w") as f:
        f.write(text)


CUBE_FV_SOLUTION = """FoamFile
{
    version     2.0;
    format      ascii;
    class       dictionary;
    location    "system";
    object      fvSolution;
}

solvers
{
    p
    {
        solver          GAMG;
        tolerance       1e-06;
        relTol          0.01;
        smoother        GaussSeidel;
    }

    U
    {
        solver          smoothSolver;
        smoother        symGaussSeidel;
        tolerance       1e-05;
        relTol          0;
    }
}

PISO
{
    nCorrectors     2;
    nNonOrthogonalCorrectors 0;
    pRefCell        0;
    pRefValue       0;
}
"""

DECOMPOSE_PAR_DICT = """FoamFile
{{
    version     2.0;
    format      ascii;
    class       dictionary;
    location    "system";
    object      decomposeParDict;
}}

numberOfSubdomains {n};
method          simple;
simpleCoeffs
{{
    n           (1 1 {n});
    delta       0.001;
}}
"""


def make_cube_case(dst: str, n: int, steps: int,
                   subdomains: int = 0) -> float:
    """Write the n^3 lid-driven cube case at `dst` and return its time
    step. It is the icoFoam cavity tutorial with frontAndBack turned into
    a no-slip wall, the z extent equal to x and y, p solved by GAMG
    (tolerance 1e-6, relTol 0.01) and a time step for Courant ~0.5."""
    shutil.copytree(CAVITY, dst)
    _patch_file(os.path.join(dst, "constant", "polyMesh", "blockMeshDict"), [
        ("(0 0 0.1)", "(0 0 1)"), ("(1 0 0.1)", "(1 0 1)"),
        ("(1 1 0.1)", "(1 1 1)"), ("(0 1 0.1)", "(0 1 1)"),
        ("(20 20 1)", f"({n} {n} {n})"),
        ("frontAndBack\n    {\n        type empty;",
         "frontAndBack\n    {\n        type wall;"),
    ])
    _patch_file(os.path.join(dst, "0", "U"), [(
        "frontAndBack\n    {\n        type            empty;",
        "frontAndBack\n    {\n        type            fixedValue;\n"
        "        value           uniform (0 0 0);")])
    _patch_file(os.path.join(dst, "0", "p"), [(
        "frontAndBack\n    {\n        type            empty;",
        "frontAndBack\n    {\n        type            zeroGradient;")])
    dx = 0.1 / n                      # convertToMeters 0.1, unit cube
    dt = 0.5 * dx / LID_SPEED
    _patch_file(os.path.join(dst, "system", "controlDict"), [
        ("endTime         0.5;", f"endTime         {steps * dt!r};"),
        ("deltaT          0.005;", f"deltaT          {dt!r};"),
        # the solver writes the final time after its loop; a write
        # interval past the end avoids writing it twice
        ("writeInterval   20;", f"writeInterval   {steps + 1};"),
        ("timePrecision   6;", "timePrecision   10;"),
    ])
    with open(os.path.join(dst, "system", "fvSolution"), "w") as f:
        f.write(CUBE_FV_SOLUTION)
    if subdomains:
        with open(os.path.join(dst, "system", "decomposeParDict"), "w") as f:
            f.write(DECOMPOSE_PAR_DICT.format(n=subdomains))
    return dt


def clone_case(src: str, dst: str) -> None:
    """Copy a meshed case without its time directories other than 0."""
    shutil.copytree(src, dst, ignore=lambda d, names: [
        x for x in names if d == src and _is_time_dir(x) and x != "0"])


def _is_time_dir(name: str) -> bool:
    try:
        float(name)
    except ValueError:
        return False
    return True


# ---------------------------------------------------------------------------
# reading what the CLI wrote (plain numpy: this process stays off the GPU)
# ---------------------------------------------------------------------------

_INTERNAL = re.compile(
    r"internalField\s+(?:uniform\s+(?P<u>\([^)]*\)|[^;\s]+)\s*;|"
    r"nonuniform\s+List<(?P<kind>\w+)>\s*(?P<n>\d+)\s*\()")


def read_internal_field(path: str, n_cells: int):
    import numpy as np

    with open(path) as f:
        text = f.read()
    m = _INTERNAL.search(text)
    if m is None:
        raise ValueError(f"{path}: no internalField")
    if m.group("u") is not None:
        vals = np.array(m.group("u").strip("()").split(), dtype=np.float64)
        return np.tile(vals, (n_cells, 1)).squeeze()
    n = int(m.group("n"))
    end = re.compile(r"\)\s*;").search(text, m.end())
    body = text[m.end():end.start()].replace("(", " ").replace(")", " ")
    arr = np.array(body.split(), dtype=np.float64)
    width = 3 if m.group("kind") == "vector" else 1
    if arr.size != n * width:
        raise ValueError(f"{path}: {arr.size} values for {n} x {width}")
    return arr.reshape(n, width).squeeze(axis=1) if width == 1 else \
        arr.reshape(n, 3)


def latest_time_dir(case: str) -> str:
    times = [x for x in os.listdir(case) if _is_time_dir(x)
             and os.path.isdir(os.path.join(case, x))]
    return os.path.join(case, max(times, key=float))


def final_fields(case: str, n_cells: int, names=("U", "p")):
    tdir = latest_time_dir(case)
    if os.path.basename(tdir) == "0":
        raise PhaseFailed(f"{case}: no time directory was written")
    return {k: read_internal_field(os.path.join(tdir, k), n_cells)
            for k in names}


# ---------------------------------------------------------------------------
# child processes
# ---------------------------------------------------------------------------


def child_env(kind: str, x64: bool = False, extra=None) -> dict:
    """Environment of a CLI child: 'gpu' fails if CUDA does not start,
    'cpu' never opens a card."""
    env = dict(os.environ)
    env["PYTHONUNBUFFERED"] = "1"
    env["JAX_PLATFORMS"] = "cuda" if kind == "gpu" else "cpu"
    if kind == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    for k in ("FOAMTPU_X64", "JAX_ENABLE_X64", "FOAMTPU_HALO"):
        env.pop(k, None)
    if x64:
        env["FOAMTPU_X64"] = "1"
        env["JAX_ENABLE_X64"] = "1"
    env.update(extra or {})
    return env


class Run:
    """One finished child: exit code, wall seconds and its output lines,
    each stamped with the seconds since the child started."""

    def __init__(self, rc, seconds, lines):
        self.rc, self.seconds, self.lines = rc, seconds, lines

    def text(self):
        return "\n".join(line for _, line in self.lines)


def run_child(argv, env, log_path: str, timeout: float) -> Run:
    t0 = time.perf_counter()
    lines = []
    with open(log_path, "a") as log:
        log.write(f"$ {' '.join(argv)}\n")
        proc = subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, bufsize=1)
        timer = threading.Timer(timeout, proc.kill)
        timer.start()
        try:
            for line in proc.stdout:
                lines.append((time.perf_counter() - t0, line.rstrip("\n")))
                log.write(line)
            rc = proc.wait()
        finally:
            timer.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return Run(rc, time.perf_counter() - t0, lines)


def cli(args, env, log_path, timeout) -> Run:
    r = run_child([sys.executable, "-m", "foamtpu", *args], env, log_path,
                  timeout)
    if r.rc != 0:
        tail = "\n".join(line for _, line in r.lines[-15:])
        raise PhaseFailed(f"`foamtpu {' '.join(args)}` exited {r.rc}:\n"
                          f"{tail}")
    return r


_FLOAT = r"([-+0-9.eE]+|nan|inf|-inf)"


def step_log(run: Run, per_interval: int = 1) -> dict:
    """Per-step numbers from a solver log: host-clock seconds of each
    logged step (the log line of a step is printed after its results are
    on the host), the compile seconds of the first, continuity errors,
    p residuals and the device banner. A logged interval covers
    `per_interval` steps (SIMPLE logs once per chunk)."""
    start = None
    ends, cont, p_init, p_iters = [], [], [], []
    device = None
    for t, line in run.lines:
        if line.startswith(("Starting time loop", "Starting SIMPLE loop")):
            start = t
        elif line.startswith("ExecutionTime"):
            ends.append(t)
        elif line.startswith("Device:"):
            device = line.split(":", 1)[1].strip()
        elif line.startswith("time step continuity errors"):
            cont.append(float(re.search(r"sum local = " + _FLOAT,
                                        line).group(1)))
        elif line.startswith("Solving for p,"):
            p_init.append(float(re.search(r"Initial residual = " + _FLOAT,
                                          line).group(1)))
            p_iters.append(int(re.search(r"No Iterations (\d+)",
                                         line).group(1)))
    if start is None or not ends:
        raise PhaseFailed("solver log has no time loop")
    marks = [start] + ends
    durations = [b - a for a, b in zip(marks, marks[1:])]
    rest = sorted(durations[1:])
    steady = rest[(len(rest) - 1) // 2] if rest else 0.0
    # compile time: what the first interval, and any later one that took
    # over twice the steady time (a retrace), spent beyond a steady step
    extra = [d - steady for i, d in enumerate(durations)
             if i == 0 or d > 2 * steady]
    return {
        "setup_seconds": start,
        "compile_seconds": max(sum(extra), 0.0),
        "logged_intervals": len(durations),
        "seconds_per_step": steady / per_interval,
        "loop_seconds": ends[-1] - start,
        "continuity": cont,
        "p_initial": p_init,
        "p_iters": p_iters,
        "device": device,
    }


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def expect_device(log: dict, want: str) -> None:
    check(log["device"] is not None and log["device"].startswith(want),
          f"solver ran on {log['device']!r}, expected {want}")


def vtk_check(case: str, env, log_path, timeout, names=("U", "p")) -> str:
    cli(["foamToVTK", "-case", case], env, log_path, timeout)
    vtk_dir = os.path.join(case, "VTK")
    files = sorted(os.listdir(vtk_dir))
    check(bool(files), "foamToVTK wrote nothing")
    path = os.path.join(vtk_dir, files[-1])
    found = set()
    with open(path) as f:
        for line in f:
            if line.startswith(("SCALARS ", "VECTORS ")):
                found.add(line.split()[1])
    missing = [n for n in names if n not in found]
    check(not missing, f"foamToVTK output lacks {missing}")
    return os.path.basename(path)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

PROBE = ("import json, jax; d = jax.devices(); "
         "print(json.dumps({'platform': d[0].platform, "
         "'kind': d[0].device_kind, 'count': len(d)}))")


def nvidia_smi_lines():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise PhaseFailed(f"nvidia-smi: {e}")
    if out.returncode != 0:
        raise PhaseFailed(f"nvidia-smi exited {out.returncode}")
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def phase_device(ctx, want_count: int) -> dict:
    t0 = time.perf_counter()
    env = child_env(ctx.kind)
    env["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    r = run_child([sys.executable, "-c", PROBE], env, ctx.log("device"),
                  ctx.sizes["child_timeout"])
    check(r.rc == 0, f"JAX did not start on {ctx.kind} "
                     f"(exit {r.rc}): {r.text()[-800:]}")
    dev = json.loads(r.lines[-1][1])
    want = "gpu" if ctx.kind == "gpu" else "cpu"
    check(dev["platform"] == want,
          f"JAX platform {dev['platform']!r}, expected {want!r}")
    check(dev["count"] >= want_count,
          f"{dev['count']} device(s), need {want_count}")
    smi = nvidia_smi_lines() if ctx.kind == "gpu" else []
    for line in smi:
        print(line, flush=True)
    return {"device": dev, "nvidia_smi": smi,
            "seconds": time.perf_counter() - t0}


def phase_cube(ctx) -> dict:
    n, steps = ctx.sizes["cube_n"], ctx.sizes["cube_steps"]
    case = os.path.join(ctx.work, "cube")
    make_cube_case(case, n, steps)
    env = child_env(ctx.kind)
    log = ctx.log("cube")
    tmo = ctx.sizes["child_timeout"]
    mesh_run = cli(["blockMesh", "-case", case], child_env("cpu"), log, tmo)
    run = cli(["run", "-case", case, "-steps", str(steps)], env, log, tmo)
    sl = step_log(run)
    expect_device(sl, ctx.kind)
    fields = final_fields(case, n ** 3)
    import numpy as np

    U, p = fields["U"], fields["p"]
    umax = float(np.max(np.linalg.norm(U, axis=1)))
    out = {"n_cells": n ** 3, "steps": steps,
           "blockMesh_seconds": mesh_run.seconds,
           "run_seconds": run.seconds, **_times(sl),
           "cell_updates_per_second": n ** 3 / sl["seconds_per_step"]
           if sl["seconds_per_step"] else None,
           "continuity_max": max(sl["continuity"]),
           "max_abs_U": umax,
           "p_iters": sl["p_iters"]}
    check(sl["logged_intervals"] == steps,
          f"{sl['logged_intervals']} steps logged, expected {steps}")
    check(len(sl["continuity"]) == steps, "continuity missing from log")
    check(max(sl["continuity"]) < CONTINUITY_MAX,
          f"continuity {max(sl['continuity'])} >= {CONTINUITY_MAX}")
    check(bool(np.isfinite(U).all() and np.isfinite(p).all()),
          "non-finite U or p")
    check(umax <= U_BOUND, f"max|U| {umax} > {U_BOUND}")
    out["vtk"] = vtk_check(case, child_env("cpu"), log, tmo)
    return out


def _times(sl: dict) -> dict:
    return {k: sl[k] for k in ("setup_seconds", "compile_seconds",
                               "seconds_per_step", "loop_seconds")}


def phase_pitz(ctx) -> dict:
    iters = ctx.sizes["pitz_iters"]
    case = os.path.join(ctx.work, "pitzDaily")
    shutil.copytree(PITZ, case)
    env = child_env(ctx.kind)
    log = ctx.log("pitzDaily")
    tmo = ctx.sizes["child_timeout"]
    cli(["blockMesh", "-case", case], child_env("cpu"), log, tmo)
    run = cli(["run", "-case", case, "-steps", str(iters)], env, log, tmo)
    sl = step_log(run, per_interval=SIMPLE_CHUNK)
    expect_device(sl, ctx.kind)
    names = ("U", "p", "k", "epsilon", "nut")
    n_cells = _n_cells_from_log(run)
    fields = final_fields(case, n_cells, names)
    import numpy as np

    pi = sl["p_initial"]
    out = {"n_cells": n_cells, "iterations": iters, **_times(sl),
           "p_initial_residuals": pi}
    check(len(pi) >= 2, "fewer than two p residuals logged")
    check(pi[-1] < pi[0], f"p initial residual did not fall: {pi}")
    bad = [k for k, v in fields.items() if not np.isfinite(v).all()]
    check(not bad, f"non-finite fields {bad}")
    out["vtk"] = vtk_check(case, child_env("cpu"), log, tmo, names)
    return out


def _n_cells_from_log(run: Run) -> int:
    for _, line in run.lines:
        m = re.search(r"Starting (?:time|SIMPLE) loop: \w+, (\d+) cells",
                      line)
        if m:
            return int(m.group(1))
    raise PhaseFailed("cell count missing from log")


def phase_parity(ctx) -> dict:
    n, steps = ctx.sizes["parity_n"], ctx.sizes["parity_steps"]
    tmo = ctx.sizes["child_timeout"]
    log = ctx.log("parity")
    base = os.path.join(ctx.work, "parity_mesh")
    make_cube_case(base, n, steps)
    cli(["blockMesh", "-case", base], child_env("cpu"), log, tmo)
    runs = {"gpu_f32": (ctx.kind, False), "gpu_f64": (ctx.kind, True),
            "cpu_f64": ("cpu", True)}
    fields, out = {}, {"n_cells": n ** 3, "steps": steps}
    for name, (kind, x64) in runs.items():
        case = os.path.join(ctx.work, f"parity_{name}")
        clone_case(base, case)
        run = cli(["run", "-case", case, "-steps", str(steps)],
                  child_env(kind, x64), log, tmo)
        sl = step_log(run)
        expect_device(sl, kind)
        fields[name] = final_fields(case, n ** 3)
        out[name] = _times(sl)
    import numpy as np

    ref = fields["cpu_f64"]
    for name, bound in (("gpu_f64", PARITY_F64), ("gpu_f32", PARITY_F32)):
        for k in ("U", "p"):
            dev = float(np.max(np.abs(fields[name][k] - ref[k])))
            out[f"{name}_max_abs_d{k}"] = dev
            check(dev < bound, f"{name} {k} deviates {dev} >= {bound}")
    return out


def phase_kernels(ctx) -> dict:
    """StencilOp.matvec and the coarsest dense solve, compiled for the
    device this process opens now that every child has exited."""
    import jax
    import numpy as np

    dev = jax.devices()[0]
    want = "gpu" if ctx.kind == "gpu" else "cpu"
    check(dev.platform == want, f"this process runs on {dev.platform}")
    out = {}

    n = ctx.sizes["matvec_n"]
    deltas = tuple(s * d for d in ctx.sizes["matvec_deltas"]
                   for s in (1, -1))
    # 1% of the cells carry a COO fallback entry: the scatter-add path,
    # whose repeated indices become atomics on the GPU
    op, diag, x, A = stencil_problem(n, deltas, fallback=n // 100)
    t0 = time.perf_counter()
    y = jax.block_until_ready(
        jax.jit(lambda o, d, v: o.matvec(d, v))(op, diag, x))
    out["matvec_compile_seconds"] = time.perf_counter() - t0
    ref = A @ np.asarray(x, np.float64)
    err = float(np.max(np.abs(np.asarray(y, np.float64) - ref))
                / np.max(np.abs(ref)))
    out.update(matvec_n=n, matvec_deltas=deltas, matvec_rel_err=err)
    check(err <= MATVEC_RTOL, f"matvec rel err {err} > {MATVEC_RTOL}")

    res, secs = coarse_solve_residual(1024)
    out.update(coarse_n=1024, coarse_rel_residual=res,
               coarse_compile_seconds=secs,
               matmul_precision=str(jax.config.jax_default_matmul_precision))
    check(res <= COARSE_RTOL, f"coarsest residual {res} > {COARSE_RTOL}")
    return out


def stencil_problem(n: int, deltas, fallback: int = 0, seed: int = 0):
    """A diagonally dominant offset-stencil matrix in f32 as a StencilOp,
    with `fallback` random COO entries, plus its float64 CSR twin.
    Offsets whose neighbour falls outside the mesh carry zero."""
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sp

    from foamtpu.ops.stencil import StencilOp

    rng = np.random.default_rng(seed)
    cells = np.arange(n)
    off = -rng.uniform(0.5, 1.5, (n, len(deltas))).astype(np.float32)
    for m, d in enumerate(deltas):
        off[(cells + d < 0) | (cells + d >= n), m] = 0.0
    fb_c = rng.integers(0, n, fallback).astype(np.int32)
    fb_n = rng.integers(0, n, fallback).astype(np.int32)
    fb_v = -rng.uniform(0.5, 1.5, fallback).astype(np.float32)
    diag = (np.abs(off).sum(axis=1) + 1.0).astype(np.float32)
    np.add.at(diag, fb_c, np.abs(fb_v))
    x = rng.standard_normal(n).astype(np.float32)
    rows = np.concatenate([cells, fb_c] + [cells] * len(deltas))
    cols = np.concatenate([cells, fb_n]
                          + [np.clip(cells + d, 0, n - 1) for d in deltas])
    vals = np.concatenate([diag, fb_v] + list(off.T))
    A = sp.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=(n, n))
    op = StencilOp(tuple(int(d) for d in deltas), jnp.asarray(off),
                   jnp.asarray(fb_c), jnp.asarray(fb_n), jnp.asarray(fb_v))
    return op, jnp.asarray(diag), jnp.asarray(x), A


def coarse_solve_residual(n: int = 1024):
    """||A x - b|| / ||b|| of the GAMG coarsest-level solve (explicit
    inverse applied as a matrix-vector product) for a 2-D Dirichlet
    Poisson matrix of n cells, measured in float64 on the host, and the
    seconds its first call took."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from foamtpu.ops.stencil import StencilOp
    from foamtpu.solvers.linear import gamg

    side = int(round(n ** 0.5))
    deltas = (1, -1, side, -side)
    cells = np.arange(n)
    off = -np.ones((n, 4), np.float32)
    off[(cells % side) == side - 1, 0] = 0.0
    off[(cells % side) == 0, 1] = 0.0
    off[cells + side >= n, 2] = 0.0
    off[cells - side < 0, 3] = 0.0
    diag = np.full(n, 4.0, np.float32)
    none = jnp.zeros((0,), jnp.int32)
    op = StencilOp(deltas, jnp.asarray(off), none, none,
                   jnp.zeros((0,), jnp.float32))
    b = np.random.default_rng(1).standard_normal(n).astype(np.float32)

    t0 = time.perf_counter()
    xs = jax.block_until_ready(jax.jit(
        lambda o, d, rhs: gamg._dense_inverse(o, d) @ rhs)(op, diag, b))
    secs = time.perf_counter() - t0
    A = np.diag(diag.astype(np.float64))
    for m, d in enumerate(deltas):
        nz = off[:, m] != 0
        A[cells[nz], cells[nz] + d] = off[nz, m]
    xs = np.asarray(xs, np.float64)
    return float(np.linalg.norm(A @ xs - b) / np.linalg.norm(b)), secs


# ---------------------------------------------------------------------------
# --multi: the sharded path on four cards
# ---------------------------------------------------------------------------


def phase_multi(ctx, n_dev: int) -> dict:
    n, steps = ctx.sizes["multi_n"], ctx.sizes["multi_steps"]
    tmo = ctx.sizes["child_timeout"]
    log = ctx.log("multi")
    base = os.path.join(ctx.work, "multi_mesh")
    make_cube_case(base, n, steps, subdomains=n_dev)
    cli(["blockMesh", "-case", base], child_env("cpu"), log, tmo)
    runs = {
        "single": (["run"], {"CUDA_VISIBLE_DEVICES": "0"}
                   if ctx.kind == "gpu" else {}),
        "gspmd": (["run", "-parallel"], {}),
        "explicit": (["run", "-parallel"], {"FOAMTPU_HALO": "explicit"}),
    }
    fields, out = {}, {"n_cells": n ** 3, "steps": steps, "precision": "f64"}
    for name, (cmd, extra) in runs.items():
        case = os.path.join(ctx.work, f"multi_{name}")
        clone_case(base, case)
        run = cli(cmd + ["-case", case, "-steps", str(steps)],
                  child_env(ctx.kind, True, extra), log, tmo)
        sl = step_log(run)
        expect_device(sl, ctx.kind)
        fields[name] = final_fields(case, n ** 3)
        out[name] = _times(sl)
        if name != "single":
            spread = _spread_from_log(run)
            out[name]["spread"] = spread
            check(spread["devices"] == n_dev,
                  f"{name}: U on {spread['devices']} device(s), "
                  f"expected {n_dev}")
            want_halo = extra.get("FOAMTPU_HALO", "gspmd")
            check(spread["halo"] == want_halo,
                  f"{name}: halo {spread['halo']}, expected {want_halo}")
    import numpy as np

    for name in ("gspmd", "explicit"):
        for k in ("U", "p"):
            dev = float(np.max(np.abs(fields[name][k]
                                      - fields["single"][k])))
            out[f"{name}_max_abs_d{k}"] = dev
            check(dev < PARITY_F64,
                  f"{name} {k} deviates {dev} >= {PARITY_F64}")
    return out


def _spread_from_log(run: Run) -> dict:
    for _, line in run.lines:
        m = re.match(r"Parallel: final U on (\d+) device\(s\), halo (\w+)",
                     line)
        if m:
            return {"devices": int(m.group(1)), "halo": m.group(2)}
    raise PhaseFailed("parallel run did not report its sharding")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


class Context:
    def __init__(self, kind, sizes, work, log_dir):
        self.kind, self.sizes, self.work, self.log_dir = \
            kind, sizes, work, log_dir

    def log(self, phase: str) -> str:
        return os.path.join(self.log_dir, f"{phase}.log")


def run_phase(name, fn, *args) -> bool:
    t0 = time.perf_counter()
    try:
        rec = fn(*args)
        ok = True
    except PhaseFailed as e:
        rec, ok = {"error": str(e)}, False
    except Exception as e:          # noqa: BLE001 - reported, fails the run
        rec, ok = {"error": f"{type(e).__name__}: {e}"}, False
    emit({"phase": name, "ok": ok, "seconds": time.perf_counter() - t0,
          **rec})
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card `run -parallel` phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="run the path on the CPU at toy sizes; never "
                         "reports a device result")
    ap.add_argument("--work", default=os.path.join(REPO, ".smoke_work"),
                    help="scratch directory for the cases (emptied first)")
    ap.add_argument("--log-dir", default=None,
                    help="where child logs go (default: <work>/logs)")
    a = ap.parse_args(argv)

    for path in (CAVITY, PITZ, os.path.join(REPO, "foamtpu")):
        if not os.path.exists(path):
            print(f"chip_smoke: {path} missing; run from a foamtpu "
                  f"checkout", file=sys.stderr)
            return 2
    kind = "cpu" if a.rehearse else "gpu"
    sizes = TOY if a.rehearse else FULL
    shutil.rmtree(a.work, ignore_errors=True)
    os.makedirs(a.work)
    log_dir = a.log_dir or os.path.join(a.work, "logs")
    os.makedirs(log_dir, exist_ok=True)
    ctx = Context(kind, sizes, a.work, log_dir)
    n_dev = 4 if a.multi else 1
    if a.rehearse and a.multi:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=4").strip()

    probe = {}

    def device():
        probe.update(phase_device(ctx, n_dev))
        return probe

    try:
        if not run_phase("device", device):
            return 1
        if a.multi:
            phases = [("multi", phase_multi, ctx, n_dev)]
        else:
            phases = [("cube", phase_cube, ctx),
                      ("pitzDaily", phase_pitz, ctx),
                      ("parity", phase_parity, ctx)]
        ok = all([run_phase(*p) for p in phases])
        if not a.multi:
            # the only phase that opens the device in this process
            os.environ["JAX_PLATFORMS"] = "cuda" if kind == "gpu" else "cpu"
            sys.path.insert(0, REPO)
            ok = run_phase("kernels", phase_kernels, ctx) and ok
    finally:
        for x in os.listdir(a.work):        # the cases; logs stay
            if os.path.join(a.work, x) != log_dir:
                shutil.rmtree(os.path.join(a.work, x), ignore_errors=True)
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    if a.rehearse:
        print("chip_smoke: rehearsal passed on the CPU; no device result",
              file=sys.stderr)
        return 0
    dev = probe["device"]
    emit({"ok": True, "device": {"platform": dev["platform"],
                                 "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
