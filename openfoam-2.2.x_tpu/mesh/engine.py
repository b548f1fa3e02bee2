"""engine — IC-engine crank-angle time and piston mesh motion.

Rebuild of reference: src/engine/ (engineTime: user time in crank-angle
degrees, rpm/conRodLength/stroke/clearance from constant/
engineGeometry; enginePiston/layerAR mesh motion) and the solvers
applications/solvers/combustion/{engineFoam,coldEngineFoam}/.

Redesign — the reference moves the piston by adding/removing cell
layers (topology change). Here the cylinder mesh KEEPS its topology
and the points between the piston crown and the head are stretched
linearly (the same static-topology ALE treatment as
mesh/moving.py::solidBodyMotion), so the whole compression runs inside
one jitted program. Layering's contact-surface use cases (valves) are
out of scope; compression/expansion strokes are exact.

Slider-crank kinematics (reference: engineTime::pistonPosition):
    s(theta) = R + L - (R cos(theta) + sqrt(L^2 - R^2 sin^2(theta)))
with R = stroke/2, L = conRodLength; s is the distance below TDC
(s(0) = 0 at TDC, s(180) = stroke at BDC). Crank angle advances at
6*rpm degrees per second; controlDict times for engine solvers are in
CAD (reference: engineTime userTime).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import jax.numpy as jnp


class EngineGeometry(NamedTuple):
    rpm: float = 1000.0
    con_rod_length: float = 0.15
    stroke: float = 0.1
    clearance: float = 0.01     # clearance height at TDC
    theta0: float = -180.0      # crank angle at startTime [CAD]
    axis: int = 1               # piston moves along this axis (y default)


def from_dict(d) -> EngineGeometry:
    """Build from a constant/engineGeometry FoamDict (dimensioned
    entries allowed)."""
    def g(key, default):
        v = d.get(key, default)
        if isinstance(v, list):      # dimensioned: name [dims] value
            v = v[-1]
        try:
            return float(v)
        except (TypeError, ValueError):
            return default

    return EngineGeometry(
        rpm=g("rpm", 1000.0),
        con_rod_length=g("conRodLength", 0.15),
        stroke=g("stroke", 0.1),
        clearance=g("clearance", 0.01),
        theta0=g("theta0", g("startTheta", -180.0)),
        axis=int(g("axis", 1)))


def deg_per_sec(geom: EngineGeometry) -> float:
    return 6.0 * geom.rpm


def cad_to_seconds(geom: EngineGeometry, cad: float) -> float:
    """engineTime: user time (CAD) -> solver time (s)."""
    return cad / deg_per_sec(geom)


def piston_displacement(geom: EngineGeometry, theta_deg):
    """Distance of the piston crown below TDC at crank angle theta."""
    R = geom.stroke / 2.0
    L = geom.con_rod_length
    th = theta_deg * jnp.pi / 180.0
    return (R + L) - (R * jnp.cos(th)
                      + jnp.sqrt(L * L - (R * jnp.sin(th)) ** 2))


def piston_speed(geom: EngineGeometry, theta_deg):
    """d s / d t at theta [m/s] (analytic derivative)."""
    R = geom.stroke / 2.0
    L = geom.con_rod_length
    th = theta_deg * jnp.pi / 180.0
    om = deg_per_sec(geom) * jnp.pi / 180.0       # rad/s
    s, c = jnp.sin(th), jnp.cos(th)
    root = jnp.sqrt(L * L - (R * s) ** 2)
    return om * (R * s + (R * R * s * c) / root)


def piston_layer_motion(geom: EngineGeometry, planes, side: int,
                        theta_start: float
                        ) -> Tuple[Callable, Callable]:
    """Motion functions for ONE static-topology chunk of a layerAR
    engine run (reference: src/engine/engineMesh layered motion +
    polyTopoChange layerAdditionRemoval — see mesh/topo.py): only the
    piston plane itself moves; the layer adjacent to it stretches,
    everything beyond the first interior plane is static. `t` is
    seconds since the CHUNK start (crank angle theta_start)."""
    ax = geom.axis
    dps = deg_per_sec(geom)
    planes = [float(p) for p in planes]
    if side == 0:
        z0, z_fix = planes[0], planes[1]
        sgn = 1.0          # crown below the fixed plane
    else:
        z0, z_fix = planes[-1], planes[-2]
        sgn = -1.0
    s_start = float(piston_displacement(geom, theta_start))
    # TDC crown coordinate consistent with the chunk-start mesh
    z_tdc = z0 + sgn * s_start
    h_span = abs(z_fix - z0)
    eps = 1e-6 * max(h_span, 1e-30)

    def z_piston(t):
        theta = theta_start + dps * t
        return z_tdc - sgn * piston_displacement(geom, theta)

    def pts(p0, t):
        zp = z_piston(t)
        moving = sgn * (z0 + sgn * eps - p0[:, ax]) >= 0.0
        return p0.at[:, ax].set(jnp.where(moving, zp, p0[:, ax]))

    def umesh(x, t):
        theta = theta_start + dps * t
        vp = -sgn * piston_speed(geom, theta)  # crown velocity (signed)
        zp = z_piston(t)
        lam = (z_fix - x[..., ax]) / jnp.where(
            jnp.abs(z_fix - zp) < eps, eps, z_fix - zp)
        u = jnp.zeros_like(x)
        return u.at[..., ax].set(jnp.clip(lam, 0.0, 1.0) * vp)

    return pts, umesh


def piston_motion(geom: EngineGeometry, z_head: float, z_piston0: float
                  ) -> Tuple[Callable, Callable]:
    """Motion functions for mesh/moving.py. The mesh is built at crank
    angle theta0 with the piston crown at z_piston0 (coordinates along
    `geom.axis`, head ABOVE piston: z_head > z_piston). Points scale
    linearly between the (moving) crown and the (fixed) head.

    Reference: enginePiston + the engineTopoChangerMesh family —
    replaced by static-topology linear stretching."""
    ax = geom.axis
    dps = deg_per_sec(geom)
    # TDC crown position derived from the MESH's crown position at
    # theta0 (guarantees pts(p0, t=0) == p0 exactly); the dictionary
    # `clearance` is not trusted to match the mesh to float precision
    z_tdc = z_piston0 + float(piston_displacement(geom, geom.theta0))

    def z_piston(t):
        theta = geom.theta0 + dps * t
        return z_tdc - piston_displacement(geom, theta)

    h0 = z_head - z_piston0

    def pts(p0, t):
        zp = z_piston(t)
        lam = (z_head - p0[:, ax]) / h0       # 0 at head, 1 at crown
        z_new = z_head - lam * (z_head - zp)
        return p0.at[:, ax].set(z_new)

    def umesh(x, t):
        theta = geom.theta0 + dps * t
        vp = -piston_speed(geom, theta)        # crown velocity (signed)
        zp = z_piston(t)
        lam = (z_head - x[..., ax]) / jnp.maximum(z_head - zp, 1e-12)
        u = jnp.zeros_like(x)
        return u.at[..., ax].set(lam * vp)

    return pts, umesh
