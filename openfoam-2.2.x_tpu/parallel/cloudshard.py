"""Sharded Lagrangian cloud: owner-shard residence + bucketed
all_to_all particle transfer.

Reference: src/lagrangian/basic/Cloud/Cloud.C processor transfer —
particles crossing a processor boundary are packed into per-neighbour
transfer lists and exchanged point-to-point; each particle always
lives with the processor that owns its cell (SURVEY.md §2b "bucketed
all_to_all"; VERDICT r4 missing #5).

Redesign (shard_map over the same 'space' device axis the fields
use):

- The STATIC geometry tables (cface/csign/sf/cf/cnbr — a few MB) are
  replicated on every shard, so the bounded face-walk needs no halo
  mid-hop; only the DYNAMIC carrier fields (U, T — the arrays that
  actually scale) stay cell-sharded.
- Each shard owns a fixed block of cells (jax.sharding partitions the
  cell axis into contiguous blocks) and a fixed block of particle
  slots. The residence invariant — particle.cell lies in its shard's
  cell block — makes the drag/heating gather U_blk[cell - offset]
  purely shard-local (zero communication), exactly the locality the
  reference's per-processor cloud buys.
- After the tracking walk, particles that crossed a shard boundary are
  re-bucketed: ranked per destination by a sort, packed into a
  fixed-width [n_dev, cap] send buffer, exchanged with ONE
  lax.all_to_all, and compacted into the local slots. Fixed widths
  keep every shape static under jit; overflow (more than `cap`
  migrants to one destination, or more actives than slots after a
  transfer) is reported in the step diagnostics instead of silently
  dropping parcels.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..lagrangian import Cloud, CloudConfig, _drag_update, _thermo_update, _track

_LEAVES = ("x", "u", "d", "rho", "cell", "active", "T", "pid")


def shard_cloud(cloud: Cloud, n_dev: int, n_cells: int,
                slots_per_shard: Optional[int] = None) -> Dict[str, Any]:
    """Distribute a global cloud into per-shard particle blocks by cell
    ownership (host-side, at case load). Returns the flat [n_dev * S]
    leaf dict (leading axis shardable over 'space') plus static ints."""
    nc_loc = n_cells // n_dev
    cell = np.asarray(cloud.cell)
    active = np.asarray(cloud.active)
    owner = np.clip(cell // nc_loc, 0, n_dev - 1)
    counts = np.bincount(owner[active], minlength=n_dev)
    S = slots_per_shard or int(max(counts.max(), 1) * 2)
    if counts.max() > S:
        raise ValueError(f"shard slot overflow at load: {counts.max()} "
                         f"particles on one shard, {S} slots")
    Np = cloud.x.shape[0]
    pid_g = np.arange(Np, dtype=np.int32)

    def blank(leaf, fill):
        out = np.full((n_dev * S,) + leaf.shape[1:], fill,
                      np.asarray(leaf).dtype)
        return out

    leaves = {
        "x": blank(np.asarray(cloud.x), 0.0),
        "u": blank(np.asarray(cloud.u), 0.0),
        "d": blank(np.asarray(cloud.d), 1e-6),
        "rho": blank(np.asarray(cloud.rho), 1e3),
        "cell": np.zeros(n_dev * S, np.int32),
        "active": np.zeros(n_dev * S, bool),
        "T": blank(np.asarray(cloud.T), 300.0) if cloud.T is not None
        else np.full(n_dev * S, 300.0, np.asarray(cloud.x).dtype),
        "pid": np.full(n_dev * S, -1, np.int32),
    }
    fill_idx = np.zeros(n_dev, np.int64)
    for pidx in np.nonzero(active)[0]:
        s = owner[pidx]
        slot = s * S + fill_idx[s]
        fill_idx[s] += 1
        for k, src in (("x", cloud.x), ("u", cloud.u), ("d", cloud.d),
                       ("rho", cloud.rho), ("cell", cell),
                       ("T", cloud.T)):
            if src is not None:
                leaves[k][slot] = np.asarray(src)[pidx]
        # residence: cells stay global indices; the invariant is
        # ownership, not renumbering
        leaves["cell"][slot] = cell[pidx]
        leaves["active"][slot] = True
        leaves["pid"][slot] = pid_g[pidx]
    # anchor inactive slots in their own shard's cell block so the
    # local gather stays in range
    for s in range(n_dev):
        sl = slice(s * S, (s + 1) * S)
        blk = leaves["cell"][sl]
        blk[~leaves["active"][sl]] = s * nc_loc
        leaves["cell"][sl] = blk
    return {k: jnp.asarray(v) for k, v in leaves.items()}, S


def place(leaves: Dict[str, Any], jmesh: Mesh, axis: str = "space"):
    """Shard the particle axis of every leaf over the device mesh."""
    sh = NamedSharding(jmesh, P(axis))

    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(jmesh, spec))

    return {k: put(v) for k, v in leaves.items()}


def make_sharded_evolve(mesh, bt, cfg: CloudConfig, jmesh: Mesh, S: int,
                        cap: Optional[int] = None, axis: str = "space"):
    """Build the jittable sharded cloud step.

    Returns step(leaves, U_cell, dt[, T_cell]) -> (leaves, diag) where
    U_cell/T_cell are the CELL-SHARDED carrier fields ([nC,...] with
    the cell axis over `axis`) and leaves is the particle-sharded
    dict from shard_cloud/place. diag carries overflow counters."""
    try:
        from jax import shard_map as _sm

        def shard_map(f, **kw):            # jax >= 0.8 spelling
            kw["check_vma"] = kw.pop("check_rep")
            return _sm(f, **kw)
    except ImportError:
        from jax.experimental.shard_map import shard_map

    n_dev = jmesh.devices.size
    n_cells = mesh.n_cells
    nc_loc = n_cells // n_dev
    C = cap or S  # per-destination transfer width

    bt = jnp.asarray(bt)

    def local_step(lv: Dict[str, Any], U_blk, T_blk, dt):
        # lv leaves [S,...]; U_blk [nc_loc,3] (this shard's cells)
        i = jax.lax.axis_index(axis)
        off = i * nc_loc
        cell_loc = lv["cell"] - off        # residence invariant
        u_f = U_blk[cell_loc]
        cl = Cloud(x=lv["x"], u=lv["u"], d=lv["d"], rho=lv["rho"],
                   cell=lv["cell"], active=lv["active"], T=lv["T"])
        if cfg.solve_T and getattr(T_blk, "ndim", 0) >= 1:
            cl = _thermo_update(cl, u_f, T_blk[cell_loc], dt, cfg)
        cl = _drag_update(cl, u_f, dt, cfg)
        cl = _track(mesh, cl, dt, bt, cfg)

        # --- bucketed transfer ------------------------------------------------
        dest = jnp.clip(cl.cell // nc_loc, 0, n_dev - 1)
        dest = jnp.where(cl.active, dest, i)   # dead slots stay home
        order = jnp.argsort(dest, stable=True)
        dsort = dest[order]
        counts = jnp.bincount(dest, length=n_dev)
        offs = jnp.concatenate([jnp.zeros(1, counts.dtype),
                                jnp.cumsum(counts)[:-1]])
        rank = jnp.arange(S) - offs[dsort]
        overflow_send = jnp.sum((rank >= C)
                                & cl.active[order]).astype(jnp.int32)
        ok = rank < C
        slot = jnp.where(ok, dsort * C + rank, n_dev * C)  # drop chute

        out = {"x": cl.x, "u": cl.u, "d": cl.d, "rho": cl.rho,
               "cell": cl.cell, "T": cl.T, "pid": lv["pid"],
               "active": cl.active}

        def pack(leaf, fill):
            buf = jnp.full((n_dev * C + 1,) + leaf.shape[1:], fill,
                           leaf.dtype)
            return buf.at[slot].set(leaf[order])[:-1]

        sent = {
            "x": pack(out["x"], 0.0), "u": pack(out["u"], 0.0),
            "d": pack(out["d"], 1e-6), "rho": pack(out["rho"], 1e3),
            "cell": pack(out["cell"], 0), "T": pack(out["T"], 300.0),
            "pid": pack(out["pid"], -1),
            "active": pack(out["active"], False),
        }
        recv = {}
        for k, v in sent.items():
            v = v.reshape((n_dev, C) + v.shape[1:])
            r = jax.lax.all_to_all(v, axis, split_axis=0, concat_axis=0,
                                   tiled=False)
            recv[k] = r.reshape((n_dev * C,) + v.shape[2:])

        # compact actives into the S local slots (actives first);
        # pad first when the total receive width n_dev*cap < S
        if n_dev * C < S:
            padw = S - n_dev * C
            for k in recv:
                fill = jnp.zeros((padw,) + recv[k].shape[1:],
                                 recv[k].dtype)
                recv[k] = jnp.concatenate([recv[k], fill], axis=0)
        act = recv["active"]
        key = jnp.where(act, 0, 1)
        corder = jnp.argsort(key, stable=True)
        n_act = jnp.sum(act.astype(jnp.int32))
        overflow_recv = jnp.maximum(n_act - S, 0)
        take = corder[:S]
        new = {k: v[take] for k, v in recv.items()}
        new["active"] = new["active"] & (jnp.arange(S) < n_act)
        # anchor dead slots in-shard for the next local gather
        new["cell"] = jnp.where(new["active"], new["cell"], off).astype(
            jnp.int32)
        diag = {"overflow_send": overflow_send[None],
                "overflow_recv": overflow_recv[None],
                "n_active": n_act[None]}
        return new, diag

    leaf_specs = {k: P(axis) for k in _LEAVES}
    diag_specs = {"overflow_send": P(axis), "overflow_recv": P(axis),
                  "n_active": P(axis)}

    def step(leaves, U_cell, dt, T_cell=None):
        # dt enters as an explicit replicated arg (shard_map closures
        # over tracers are fragile across jax versions)
        fn = shard_map(
            local_step,
            mesh=jmesh,
            in_specs=(leaf_specs,
                      P(axis, *([None] * (U_cell.ndim - 1))),
                      (P(axis) if T_cell is not None else P()),
                      P()),
            out_specs=(leaf_specs, diag_specs),
            check_rep=False)
        return fn(leaves, U_cell,
                  T_cell if T_cell is not None
                  else jnp.zeros((), U_cell.dtype),
                  jnp.asarray(dt, U_cell.dtype))

    return step


def gather_cloud(leaves: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Host-side: pull the sharded cloud back as global arrays sorted
    by particle id (actives only) — for IO and oracle comparison."""
    act = np.asarray(leaves["active"])
    pid = np.asarray(leaves["pid"])
    idx = np.nonzero(act & (pid >= 0))[0]
    idx = idx[np.argsort(pid[idx])]
    return {k: np.asarray(v)[idx] for k, v in leaves.items()}
