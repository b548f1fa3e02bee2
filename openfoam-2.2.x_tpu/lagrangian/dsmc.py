"""dsmc — direct simulation Monte Carlo (variable hard sphere).

Rebuild of reference: src/lagrangian/dsmc/ (dsmcCloud, dsmcParcel,
BinaryCollisionModel/VariableHardSphere, WallInteractionModel/
{SpecularReflection,MaxwellianThermal}) and
applications/solvers/discreteMethods/dsmc/dsmcFoam/.

Redesign — the reference's per-cell occupancy lists and sequential
collision loops become flat, fixed-shape array programs:

- The cloud is the same fixed-slot struct-of-arrays layout as the
  kinematic cloud; free flight reuses the data-parallel face-walk
  (`lagrangian._track` geometry) with wall codes extended to a diffuse
  (Maxwellian) reflection option.
- Collision binning: particles are ranked within their cell by a
  single stable argsort over cell ids (no occupancy lists); per-cell
  counts/offsets come from one segment_sum + cumsum.
- NTC selection (reference: dsmcCloud::collisions, Bird's
  no-time-counter): the per-cell candidate count
      n_cand = 0.5 nP (nP-1) F_N (sigma_T c_r)_max dt / V_c
  is spread over a FIXED number of candidate rounds K (static shape);
  each round draws one random pair per cell and accepts with
      P = (n_cand / K) * sigma_T c_r / (sigma_T c_r)_max.
  One pair per cell per round means all writes in a round are disjoint,
  so the K rounds run as a lax.fori_loop of masked scatters. The
  per-cell (sigma_T c_r)_max is tracked as a running maximum, as the
  reference does (sigmaTcRMax).
- VHS cross-section sigma_T = pi d_ref^2 (c_r,ref/c_r)^(2 omega - 1)
  with isotropic post-collision scattering; momentum and energy are
  conserved exactly per accepted pair.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import BND_ESCAPE, BND_WALL

K_BOLTZ = 1.380649e-23


class DsmcCloud(NamedTuple):
    """Fixed-slot struct-of-arrays DSMC parcel cloud."""
    x: Any        # [Np,3]
    u: Any        # [Np,3]
    typ: Any      # [Np] int32 species index
    cell: Any     # [Np] int32
    active: Any   # [Np] bool
    sigma_cr_max: Any  # [nC] running max of sigma_T*c_r per cell
    key: Any      # PRNG key

    @property
    def n_active(self):
        return jnp.sum(self.active.astype(jnp.int32))


class Species(NamedTuple):
    """VHS species properties (reference: dsmcParcel::constantProperties)."""
    mass: Any      # [nSp] kg
    d_ref: Any     # [nSp] m, VHS reference diameter
    omega: Any     # [nSp] viscosity-temperature exponent
    T_ref: float = 273.0


class DsmcConfig(NamedTuple):
    nEquivalentParticles: float = 1e12   # F_N
    n_rounds: int = 4                    # candidate rounds per step
    max_hops: int = 8
    wall_T: float = 300.0
    diffuse_walls: bool = False          # Maxwellian thermal walls


def maxwellian(key, n, mass, T, U0=(0.0, 0.0, 0.0), dtype=jnp.float32):
    """Sample n velocities from a Maxwell-Boltzmann distribution."""
    sd = jnp.sqrt(K_BOLTZ * T / mass)
    return (jnp.asarray(U0, dtype)[None, :]
            + sd * jax.random.normal(key, (n, 3), dtype))


def initialise(mesh, species: Species, number_density, T, U0,
               fn, typ_fracs=None, seed=0, slack=1.25) -> DsmcCloud:
    """Uniform fill: equivalent-parcel count per cell from the target
    number density (reference: dsmcInitialise / dsmcCloud::initialise).
    Deterministic low-discrepancy placement inside each cell's bounding
    box (host-side)."""
    rng = np.random.default_rng(seed)
    v = np.asarray(mesh.v)
    n_per_cell = number_density * v / fn
    n_int = np.floor(n_per_cell + rng.random(v.shape)).astype(int)
    total = int(n_int.sum())
    ns = int(total * slack) + 8
    nsp = int(np.asarray(species.mass).shape[0])
    fracs = (np.full(nsp, 1.0 / nsp) if typ_fracs is None
             else np.asarray(typ_fracs, float))
    fracs = fracs / fracs.sum()

    # place parcels in cell bounding boxes; resample toward centre to
    # stay inside non-box cells (the face-walk self-corrects anyway)
    c = np.asarray(mesh.c)
    cells = np.repeat(np.arange(mesh.n_cells), n_int)
    h = np.cbrt(v)[cells]
    pos = c[cells] + (rng.random((total, 3)) - 0.5) * 0.9 * h[:, None]
    typ = rng.choice(nsp, size=total, p=fracs)
    mass = np.asarray(species.mass)[typ]
    sd = np.sqrt(K_BOLTZ * T / mass)
    vel = np.asarray(U0, float)[None, :] + sd[:, None] * rng.standard_normal(
        (total, 3))

    dt = mesh.v.dtype
    x = np.zeros((ns, 3)); x[:total] = pos
    u = np.zeros((ns, 3)); u[:total] = vel
    t = np.zeros(ns, np.int32); t[:total] = typ
    cl = np.zeros(ns, np.int32); cl[:total] = cells
    act = np.zeros(ns, bool); act[:total] = True
    # initial sigma_cr_max estimate: sigma(T) * 4 * most-probable speed
    d0 = float(np.asarray(species.d_ref).max())
    cr0 = 4.0 * float(np.sqrt(2.0 * K_BOLTZ * T / mass.min()))
    scm = np.full(mesh.n_cells, np.pi * d0 * d0 * cr0)
    return DsmcCloud(
        x=jnp.asarray(x, dt), u=jnp.asarray(u, dt),
        typ=jnp.asarray(t), cell=jnp.asarray(cl), active=jnp.asarray(act),
        sigma_cr_max=jnp.asarray(scm, dt),
        key=jax.random.PRNGKey(seed))


def _sigma_T(species: Species, typ_i, typ_j, cr):
    """VHS total cross-section for a colliding pair (reference:
    VariableHardSphere::sigmaTcR, Bird eq. 4.63)."""
    d = 0.5 * (species.d_ref[typ_i] + species.d_ref[typ_j])
    om = 0.5 * (species.omega[typ_i] + species.omega[typ_j])
    m_i, m_j = species.mass[typ_i], species.mass[typ_j]
    # reduced mass as m_i * fraction — m_i*m_j (~1e-51) underflows f32
    m_r = m_i * (m_j / (m_i + m_j))
    # Bird: sigma_T = pi d^2 [2kTref/(m_r cr^2)]^(omega-1/2) / Gamma(5/2-omega)
    arg = (2.0 * K_BOLTZ * species.T_ref / m_r) / jnp.maximum(
        cr * cr, 1e-30)
    gam = jnp.exp(jax.lax.lgamma(2.5 - om))
    return jnp.pi * d * d * arg ** (om - 0.5) / gam


def _free_flight(mesh, cloud: DsmcCloud, dt, bt, cfg: DsmcConfig,
                 species: Species) -> DsmcCloud:
    """Ballistic transport via the kinematic face-walk; diffuse walls
    resample the outgoing velocity from a wall-temperature Maxwellian
    biased flux distribution (reference: MaxwellianThermal)."""
    from . import _track, Cloud, CloudConfig

    kc = Cloud(x=cloud.x, u=cloud.u, d=jnp.zeros_like(cloud.x[:, 0]),
               rho=jnp.ones_like(cloud.x[:, 0]), cell=cloud.cell,
               active=cloud.active, T=None)
    kcfg = CloudConfig(drag=False, g=(0.0, 0.0, 0.0),
                       max_hops=cfg.max_hops, e_wall=1.0)
    kc = _track(mesh, kc._replace(u=cloud.u), dt, bt, kcfg)
    out = cloud._replace(x=kc.x, u=kc.u, cell=kc.cell, active=kc.active)
    if cfg.diffuse_walls:
        # particles whose velocity changed at a wall this step get a
        # thermal resample (approximation: specular geometry + thermal
        # speed — full in-walk resampling would need the PRNG inside
        # the fori_loop; this matches equilibrium wall flux statistics)
        key, k1 = jax.random.split(cloud.key)
        hit = jnp.any(kc.u != cloud.u, axis=1) & kc.active
        m = species.mass[cloud.typ]
        sd = jnp.sqrt(K_BOLTZ * cfg.wall_T / m)
        nrm = jax.random.normal(k1, cloud.u.shape, cloud.u.dtype)
        dirn = kc.u / jnp.maximum(
            jnp.linalg.norm(kc.u, axis=1, keepdims=True), 1e-300)
        speed = jnp.linalg.norm(sd[:, None] * nrm, axis=1, keepdims=True)
        u_diff = dirn * speed
        out = out._replace(u=jnp.where(hit[:, None], u_diff, kc.u),
                           key=key)
    return out


def _collide(mesh, cloud: DsmcCloud, dt, cfg: DsmcConfig,
             species: Species) -> DsmcCloud:
    """NTC binary collisions, K fixed rounds of one pair per cell."""
    nC = mesh.n_cells
    ns = cloud.active.shape[0]
    dtype = cloud.x.dtype

    # ---- bin particles by cell (stable sort; inactive sort last) ----
    cell_key = jnp.where(cloud.active, cloud.cell, nC)
    perm = jnp.argsort(cell_key, stable=True)          # [Np] sorted ids
    counts = jax.ops.segment_sum(cloud.active.astype(jnp.int32),
                                 cloud.cell, num_segments=nC)
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    vc = mesh.v
    fn = jnp.asarray(cfg.nEquivalentParticles, dtype)
    nP = counts.astype(dtype)
    n_cand = (0.5 * nP * (nP - 1.0) * fn * cloud.sigma_cr_max * dt
              / vc) / cfg.n_rounds

    def round_body(_, carry):
        u, scm, key = carry
        key, k1, k2, k3, k4 = jax.random.split(key, 5)
        r1 = jax.random.uniform(k1, (nC,))
        r2 = jax.random.uniform(k2, (nC,))
        i_loc = jnp.floor(r1 * nP).astype(jnp.int32)
        j_loc = jnp.floor(r2 * (nP - 1.0)).astype(jnp.int32)
        j_loc = jnp.where(j_loc >= i_loc, j_loc + 1, j_loc)  # j != i
        ok = counts >= 2
        i_idx = perm[jnp.clip(offsets + i_loc, 0, ns - 1)]
        j_idx = perm[jnp.clip(offsets + j_loc, 0, ns - 1)]
        cr_vec = u[i_idx] - u[j_idx]
        cr = jnp.linalg.norm(cr_vec, axis=1)
        sig = _sigma_T(species, cloud.typ[i_idx], cloud.typ[j_idx], cr)
        sig_cr = sig * cr
        scm_new = jnp.where(ok, jnp.maximum(scm, sig_cr), scm)
        p_acc = n_cand * sig_cr / jnp.maximum(scm_new, 1e-300)
        accept = ok & (jax.random.uniform(k3, (nC,), dtype) < p_acc)
        # isotropic VHS scattering
        m_i = species.mass[cloud.typ[i_idx]]
        m_j = species.mass[cloud.typ[j_idx]]
        msum = m_i + m_j
        ucm = (m_i[:, None] * u[i_idx] + m_j[:, None] * u[j_idx]) \
            / msum[:, None]
        ct = 2.0 * jax.random.uniform(k4, (nC,), dtype) - 1.0
        st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
        phi = 2.0 * jnp.pi * jax.random.uniform(
            jax.random.fold_in(k4, 1), (nC,), dtype)
        e = jnp.stack([ct, st * jnp.cos(phi), st * jnp.sin(phi)], axis=1)
        cr_new = cr[:, None] * e
        ui_new = ucm + (m_j / msum)[:, None] * cr_new
        uj_new = ucm - (m_i / msum)[:, None] * cr_new
        acc = accept[:, None]
        u = u.at[i_idx].set(jnp.where(acc, ui_new, u[i_idx]))
        u = u.at[j_idx].set(jnp.where(acc, uj_new, u[j_idx]))
        return u, scm_new, key

    u, scm, key = jax.lax.fori_loop(
        0, cfg.n_rounds, round_body,
        (cloud.u, cloud.sigma_cr_max, cloud.key))
    return cloud._replace(u=u, sigma_cr_max=scm, key=key)


def evolve(mesh, cloud: DsmcCloud, dt, bt, cfg: DsmcConfig,
           species: Species) -> DsmcCloud:
    """One DSMC step: free flight then collisions (reference:
    dsmcCloud::evolve)."""
    cloud = _free_flight(mesh, cloud, dt, bt, cfg, species)
    return _collide(mesh, cloud, dt, cfg, species)


def sample_fields(mesh, cloud: DsmcCloud, species: Species, fn):
    """Instantaneous macroscopic fields (reference: dsmcCloud::
    calculateFields): number density, mass-average velocity,
    translational temperature."""
    nC = mesh.n_cells
    w = cloud.active.astype(cloud.x.dtype)
    m = species.mass[cloud.typ] * w
    cnt = jax.ops.segment_sum(w, cloud.cell, num_segments=nC)
    msum = jax.ops.segment_sum(m, cloud.cell, num_segments=nC)
    mom = jax.ops.segment_sum(m[:, None] * cloud.u, cloud.cell,
                              num_segments=nC)
    U = mom / jnp.maximum(msum, 1e-300)[:, None]
    ke = jax.ops.segment_sum(
        m * jnp.sum(cloud.u * cloud.u, axis=1), cloud.cell,
        num_segments=nC)
    # T = (sum m c^2 - sum m |U|^2) / (3 k N)
    T = (ke - msum * jnp.sum(U * U, axis=1)) / jnp.maximum(
        3.0 * K_BOLTZ * cnt, 1e-300)
    rhoN = fn * cnt / mesh.v
    return {"rhoN": rhoN, "U": U, "T": T, "N": cnt}
