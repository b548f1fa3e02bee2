"""md — molecular dynamics (Lennard-Jones, velocity Verlet).

Rebuild of reference: src/lagrangian/molecularDynamics/ (molecule,
moleculeCloud with pair potentials from potential/, velocity-Verlet
integration in mdFoam's move/calculateForce split) and
applications/solvers/discreteMethods/molecularDynamics/
{mdFoam,mdEquilibrationFoam}/.

Redesign — the reference builds cell-interaction lists
(interactionLists/) to find neighbour pairs; at the molecule counts a
single chip holds (10^3-10^5), the all-pairs force matrix is a SINGLE
dense [N,N] batched computation that XLA fuses into a few kernels —
faster on this hardware than gather-heavy neighbour lists, and exactly
energy-conserving. Periodic boundaries use the minimum-image
convention over the case bounding box. A cutoff radius keeps the
potential finite-ranged (shifted-force LJ so U and F are continuous at
r_c).

mdEquilibrationFoam = mdFoam + Berendsen-style velocity rescaling
toward targetTemperature (reference: md.H's meanMomentumEnergyAndNMols
+ temperature scaling loop).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

K_BOLTZ = 1.380649e-23


class MdState(NamedTuple):
    x: Any     # [N,3] positions
    u: Any     # [N,3] velocities
    f: Any     # [N,3] forces (for the Verlet half-kick)


class MdConfig(NamedTuple):
    epsilon: float      # LJ well depth [J]
    sigma: float        # LJ length [m]
    mass: float         # molecule mass [kg]
    box: Tuple[float, float, float]   # periodic box lengths
    r_cut: float        # cutoff radius
    periodic: Tuple[bool, bool, bool] = (True, True, True)


def _pair_forces(x, cfg: MdConfig):
    """All-pairs shifted-force LJ forces + potential energy.

    Returns (f [N,3], pot [scalar]). The [N,N] displacement tensor is
    one broadcast; XLA tiles it. Self-pairs and pairs beyond r_cut are
    masked."""
    box = jnp.asarray(cfg.box, x.dtype)
    per = jnp.asarray(cfg.periodic)
    d = x[:, None, :] - x[None, :, :]                  # [N,N,3]
    d = jnp.where(per[None, None, :],
                  d - box * jnp.round(d / box), d)     # minimum image
    r2 = jnp.sum(d * d, axis=-1)
    n = x.shape[0]
    eye = jnp.eye(n, dtype=bool)
    mask = (~eye) & (r2 < cfg.r_cut ** 2)
    r2s = jnp.where(mask, r2, 1.0)
    inv_r2 = cfg.sigma ** 2 / r2s
    inv_r6 = inv_r2 ** 3
    r = jnp.sqrt(r2s)
    # plain LJ: U = 4 eps (s^12/r^12 - s^6/r^6);
    # F(r)/r = 24 eps (2 s^12/r^14 - s^6/r^8)
    fmag_over_r = 24.0 * cfg.epsilon * inv_r6 * (2.0 * inv_r6 - 1.0) / r2s
    # shifted-force correction: F_sf = F(r) - F(rc); U_sf makes both
    # continuous at rc (Allen & Tildesley eq. 5.7)
    s_rc2 = cfg.sigma ** 2 / cfg.r_cut ** 2
    s_rc6 = s_rc2 ** 3
    f_rc = 24.0 * cfg.epsilon * s_rc6 * (2.0 * s_rc6 - 1.0) / cfg.r_cut
    u_rc = 4.0 * cfg.epsilon * s_rc6 * (s_rc6 - 1.0)
    fmag_over_r = fmag_over_r - f_rc / r
    u_pair = (4.0 * cfg.epsilon * inv_r6 * (inv_r6 - 1.0) - u_rc
              + f_rc * (r - cfg.r_cut))
    w = mask.astype(x.dtype)
    f = jnp.sum((fmag_over_r * w)[:, :, None] * d, axis=1)
    pot = 0.5 * jnp.sum(u_pair * w)
    return f, pot


def verlet_step(state: MdState, dt, cfg: MdConfig):
    """One velocity-Verlet step; returns (state, potential_energy)."""
    a = state.f / cfg.mass
    u_half = state.u + 0.5 * dt * a
    x_new = state.x + dt * u_half
    box = jnp.asarray(cfg.box, state.x.dtype)
    per = jnp.asarray(cfg.periodic)
    x_new = jnp.where(per[None, :], jnp.mod(x_new, box), x_new)
    f_new, pot = _pair_forces(x_new, cfg)
    u_new = u_half + 0.5 * dt * f_new / cfg.mass
    return MdState(x=x_new, u=u_new, f=f_new), pot


def temperature(state: MdState, cfg: MdConfig):
    """Instantaneous kinetic temperature (3N dof, momentum-corrected)."""
    n = state.x.shape[0]
    u_mean = jnp.mean(state.u, axis=0)
    c = state.u - u_mean
    ke = 0.5 * cfg.mass * jnp.sum(c * c)
    return 2.0 * ke / (3.0 * n * K_BOLTZ)


def kinetic_energy(state: MdState, cfg: MdConfig):
    return 0.5 * cfg.mass * jnp.sum(state.u * state.u)


def equilibrate_step(state: MdState, dt, cfg: MdConfig, T_target,
                     relax=1.0):
    """mdEquilibrationFoam: Verlet step + velocity rescale toward
    T_target (reference: applications/solvers/discreteMethods/
    molecularDynamics/mdEquilibrationFoam/temperatureEquilibration.H)."""
    state, pot = verlet_step(state, dt, cfg)
    T_now = temperature(state, cfg)
    lam = jnp.sqrt(1.0 + relax * (T_target / jnp.maximum(T_now, 1e-30)
                                  - 1.0))
    u_mean = jnp.mean(state.u, axis=0)
    return state._replace(u=u_mean + lam * (state.u - u_mean)), pot


def lattice_fill(box, n_side, mass, T0, seed=0, dtype=np.float64):
    """Simple-cubic lattice fill with Maxwellian velocities (reference:
    mdInitialise's latticeStructure zoneFill)."""
    rng = np.random.default_rng(seed)
    b = np.asarray(box, float)
    ax = [np.linspace(0, b[i], n_side, endpoint=False) + b[i] / (2 * n_side)
          for i in range(3)]
    X, Y, Z = np.meshgrid(*ax, indexing="ij")
    x = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    n = x.shape[0]
    sd = np.sqrt(K_BOLTZ * T0 / mass)
    u = sd * rng.standard_normal((n, 3))
    u -= u.mean(axis=0)          # zero net momentum
    return x.astype(dtype), u.astype(dtype)


def make_state(x, u, cfg: MdConfig, dtype=None) -> MdState:
    x = jnp.asarray(np.asarray(x, np.float64), dtype)
    u = jnp.asarray(np.asarray(u, np.float64), dtype)
    f, _ = _pair_forces(x, cfg)
    return MdState(x=x, u=u, f=f)
