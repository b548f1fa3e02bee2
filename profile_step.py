"""Profile artifact: per-phase timing of one PISO step (cavity 400^2)
and one SIMPLE iteration (pitzDaily) on the real chip.

Answers "where does the time go" for the driver metric without needing
TensorBoard: each phase is jitted separately and timed up to
jax.block_until_ready (median of trials). Optionally writes a
jax.profiler trace when FOAMTPU_PROFILE=<dir> is set (same hook the
run CLI honours).

Run:  python profile_step.py            # on the GPU
Output: PROFILE.md-style table on stdout.
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

N = int(os.environ.get("PROF_N", "400"))


def timeit(fn, *args, reps=10, trials=3):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / reps)
    return statistics.median(ts) * 1e3  # ms


def main():
    import jax.numpy as jnp

    from bench import card_line
    from foamtpu.apps.cases import make_cavity
    from foamtpu.core import compile_cache
    from foamtpu.core.dimensions import dimTime, dimViscosity
    from foamtpu.ops import fvc, fvm, slot as slot_mod
    from foamtpu.solvers import linear, piso

    compile_cache.configure()
    print(f"card: {card_line()}", flush=True)
    mesh, state, cfg = make_cavity(N, p_solver={
        "solver": "GAMG", "preconditioner": "polynomial",
        "tolerance": 1e-7, "relTol": 0.01, "maxIter": 1000})
    dt = jnp.asarray(0.5 * (0.1 / N), mesh.v.dtype)
    step = piso.make_step(mesh, cfg)
    # settle the flow so iteration counts are representative
    for _ in range(5):
        state, diag = step(state, dt)
    jax.block_until_ready(state["U"].data)

    rows = []
    prof_dir = os.environ.get("FOAMTPU_PROFILE")
    if prof_dir:
        jax.profiler.start_trace(prof_dir)

    full_ms = timeit(lambda: step(state, dt)[0]["U"].data)
    rows.append(("full PISO step (2 corr)", full_ms))

    # --- momentum: assembly + multi-RHS solve --------------------------------
    U, p = state["U"], state["p"]
    phi = state["phi"]
    rdt = 1.0 / dt

    @jax.jit
    def mom_assemble(Ud, phi_):
        phi_sl = slot_mod.from_flat(mesh, phi_)
        Uf = U.with_data(Ud)
        eqn = (fvm.ddt(mesh, Uf, Ud, rdt)
               + fvm.div(mesh, phi_, Uf, phi_slot=phi_sl)
               - fvm.laplacian(mesh, jnp.asarray(cfg.nu, mesh.v.dtype),
                               Uf, gamma_dims=dimViscosity))
        return eqn.diag, eqn.source

    rows.append(("momentum assembly", timeit(
        lambda: mom_assemble(U.data, phi))))

    @jax.jit
    def mom_solve(Ud, phi_):
        phi_sl = slot_mod.from_flat(mesh, phi_)
        Uf = U.with_data(Ud)
        eqn = (fvm.ddt(mesh, Uf, Ud, rdt)
               + fvm.div(mesh, phi_, Uf, phi_slot=phi_sl)
               - fvm.laplacian(mesh, jnp.asarray(cfg.nu, mesh.v.dtype),
                               Uf, gamma_dims=dimViscosity))
        gp = fvc.grad_of(mesh, p, cfg.grad_scheme)
        eqn = eqn.add_source(-gp, mesh)
        x, perf = linear.solve(mesh, eqn, Ud, cfg.u_controls or {
            "solver": "PBiCGStab", "tolerance": 1e-5, "relTol": 0.1,
            "maxIter": 300})
        return x, perf

    x, uperf = mom_solve(U.data, phi)
    rows.append((f"momentum assembly+solve ({int(uperf.n_iterations)} it)",
                 timeit(lambda: mom_solve(U.data, phi)[0])))

    # --- pressure: one GAMG solve at bench settings --------------------------
    ctl = dict(cfg.p_controls)

    @jax.jit
    def p_solve(p0, b):
        rAf = jnp.full(mesh.n_faces, float(dt), mesh.v.dtype)
        pEqn = fvm.laplacian(mesh, rAf, p, corrected=False,
                             gamma_dims=dimTime)
        pEqn = pEqn.replace_fields(source=pEqn.source + b)
        pEqn, c = linear.prep_pressure(pEqn, True, ctl, 0, 0.0)
        return linear.solve(mesh, pEqn, p0, c)

    import numpy as np

    b = jnp.asarray(
        np.random.default_rng(0).standard_normal(mesh.n_cells) * 1e-4,
        mesh.v.dtype)
    xp, pperf = p_solve(p.data, b)
    rows.append((f"GAMG p-solve ({int(pperf.n_iterations)} it, relTol .01)",
                 timeit(lambda: p_solve(p.data, b)[0])))

    # --- fvc/flux plumbing: the non-solve remainder --------------------------
    @jax.jit
    def plumbing(Ud, pd):
        pf = p.with_data(pd)
        gp = fvc.grad_of(mesh, pf, cfg.grad_scheme)
        Un = Ud - dt * gp
        phi_sl = slot_mod.flux_of(mesh, Un)
        return Un, slot_mod.to_flat(mesh, phi_sl)

    rows.append(("grad(p)+flux plumbing", timeit(
        lambda: plumbing(U.data, p.data)[0])))

    if prof_dir:
        jax.profiler.stop_trace()

    print(f"\n# PISO step breakdown — cavity {N}x{N} "
          f"({mesh.n_cells} cells) on {jax.devices()[0]}")
    print(f"{'phase':44s} {'ms':>9s}")
    for name, ms in rows:
        print(f"{name:44s} {ms:9.3f}")
    solves = 3 * rows[2][1] / max(int(uperf.n_iterations), 1)
    print(f"\nfull step = {rows[0][1]:.1f} ms; "
          f"2x(momentum+p-solve) accounts for "
          f"{2 * (rows[2][1] + rows[3][1]):.1f} ms")


if __name__ == "__main__":
    main()
