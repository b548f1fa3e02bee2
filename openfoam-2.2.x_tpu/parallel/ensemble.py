"""Ensemble (batched-case) execution: vmap one solver step over N
case replicas sharing a mesh.

Capability with NO reference equivalent: the whole
finite-volume step — matrix assembly, Krylov/GAMG solves, MULES — is
a pure jit-traceable function of the state pytree, so `jax.vmap`
turns it into an N-member ensemble whose members run in lockstep on
one chip (parameter sweeps, UQ, design studies). Batched
`lax.while_loop` iterates until the slowest member converges;
finished members are frozen by JAX's select-based batching, so the
numerics of each lane match the single-case solver to roundoff.

Usage:
    step = ensemble.make_step(mesh, piso.piso_step, cfg)   # vmapped
    states = ensemble.stack([state1, state2, ...])
    states, diags = step(states, dt)                       # per-lane
    state_i = ensemble.lane(states, i)
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp


def stack(states: Sequence[Any]) -> Any:
    """Stack N compatible state pytrees along a new leading axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def lane(states: Any, i: int) -> Any:
    """Extract ensemble member i."""
    return jax.tree_util.tree_map(lambda x: x[i], states)


def n_members(states: Any) -> int:
    return jax.tree_util.tree_leaves(states)[0].shape[0]


def make_step(mesh, raw_step: Callable, cfg,
              control_dicts: Sequence[Any] = ()) -> Callable:
    """vmap + jit a raw solver step `raw_step(mesh, state, dt, cfg)`
    over the leading ensemble axis of the state. dt is shared.
    control_dicts: the same GAMG-bearing dicts make_step would pass to
    jit_with_mesh (hierarchy arrays become traced constants)."""
    from ..solvers.jitstep import jit_with_mesh

    def one(mesh_a, state, dt):
        return raw_step(mesh_a, state, dt, cfg)

    def batched(mesh_a, states, dt):
        return jax.vmap(lambda s: one(mesh_a, s, dt))(states)

    return jit_with_mesh(batched, mesh, tuple(control_dicts))
