"""Cyclic (periodic) coupled patches — internalised at mesh load
(reference: src/finiteVolume/fields/fvPatchFields/constraint/cyclic/;
the design here converts translational cyclic pairs into internal faces
with a recorded separation vector, mesh/core.py::internalize_cyclics)."""

import jax
import jax.numpy as jnp
import numpy as np

from foamtpu.bc import patchfields as pf
from foamtpu.core.dictionary import parse_string
from foamtpu.core.dimensions import DimensionSet, dimVelocity, dimless
from foamtpu.core.fields import vol_scalar, vol_vector
from foamtpu.mesh import blockmesh, to_device
from foamtpu.mesh.core import internalize_cyclics
from foamtpu.ops import fvc, fvm
from foamtpu.solvers import linear, piso

PERIODIC_CHANNEL = """
convertToMeters 1;
vertices
(
    (0 0 0) (4 0 0) (4 1 0) (0 1 0)
    (0 0 0.1) (4 0 0.1) (4 1 0.1) (0 1 0.1)
);
blocks ( hex (0 1 2 3 4 5 6 7) (24 8 1) simpleGrading (1 1 1) );
boundary
(
    inlet  { type cyclic; neighbourPatch outlet; faces ((0 4 7 3)); }
    outlet { type cyclic; neighbourPatch inlet;  faces ((2 6 5 1)); }
    walls  { type wall; faces ((3 7 6 2) (1 5 4 0)); }
    frontAndBack { type empty; faces ((0 3 2 1) (4 5 6 7)); }
);
"""


def _mesh():
    d = parse_string(PERIODIC_CHANNEL)
    return blockmesh.generate(d)


def test_internalize_topology_and_geometry():
    pm0 = _mesh()
    n_cyc = sum(p.size for p in pm0.patches if p.type == "cyclic")
    assert n_cyc == 16  # 8 faces each side
    pm = internalize_cyclics(pm0)
    # 8 new internal faces, cyclic patches gone
    assert pm.n_internal_faces == pm0.n_internal_faces + 8
    assert all(p.type != "cyclic" for p in pm.patches)
    # volumes unchanged
    np.testing.assert_allclose(pm.v.sum(), pm0.v.sum(), rtol=1e-12)
    # the periodic faces' deltas span the gap: deltaCoeff = 1/dx
    dx = 4.0 / 24
    new = slice(pm0.n_internal_faces, pm.n_internal_faces)
    np.testing.assert_allclose(pm.delta_coeffs[new], 1.0 / dx, rtol=1e-9)
    # weights are 0.5 (uniform mesh)
    np.testing.assert_allclose(pm.weights[new], 0.5, rtol=1e-9)


def test_cyclic_laplacian_exact_for_periodic_field():
    """A field periodic in x is in the null space of the x-periodic
    Laplacian only if constant along x; solving the Poisson problem with
    a periodic source must return the periodic analytic solution."""
    mesh = to_device(_mesh())
    dt = mesh.v.dtype
    bcs = tuple(pf.zero_gradient() if p.type != "empty"
                else pf.PatchField(kind="empty", vfrac=0.0)
                for p in mesh.patches)
    x = mesh.c[:, 0]
    kx = 2.0 * np.pi / 4.0
    exact = jnp.cos(kx * x)
    # - d2/dx2 cos(kx x) = kx^2 cos(kx x); discrete eigenvalue of the
    # 3-point stencil: (2 - 2 cos(kx dx))/dx^2
    dx = 4.0 / 24
    lam = (2.0 - 2.0 * np.cos(kx * dx)) / dx ** 2
    T = vol_scalar(mesh, 0.0, name="T", dims=dimless, bcs=bcs)
    eqn = fvm.laplacian(mesh, 1.0, T, corrected=False, gamma_dims=dimless)
    b = -(lam * exact) * mesh.v  # operator is negative-definite
    eqn = eqn.replace_fields(source=eqn.source + b)
    eqn = eqn.set_reference(0, float(exact[0]))
    sol, perf = linear.solve(mesh, eqn, T.data, {
        "solver": "PCG", "preconditioner": "polynomial",
        "tolerance": 1e-10, "relTol": 0.0, "maxIter": 2000})
    sol = sol - sol.mean() + exact.mean()
    np.testing.assert_allclose(np.asarray(sol), np.asarray(exact),
                               atol=5e-4)


def test_periodic_channel_piso_conserves_mass():
    """Body-force-free periodic channel with an initial plug flow: PISO
    must keep continuity tiny and the solution finite; flux through the
    periodic plane equals the interior flux (conservation across the
    cyclic)."""
    mesh = to_device(_mesh())
    ubcs, pbcs = [], []
    for p in mesh.patches:
        if p.type == "empty":
            ubcs.append(pf.PatchField(kind="empty", vfrac=0.0))
            pbcs.append(pf.PatchField(kind="empty", vfrac=0.0))
        elif p.type == "wall":
            ubcs.append(pf.fixed_value(jnp.asarray([0.0, 0.0, 0.0])))
            pbcs.append(pf.zero_gradient())
        else:
            ubcs.append(pf.zero_gradient())
            pbcs.append(pf.zero_gradient())
    U = vol_vector(mesh, jnp.asarray([1.0, 0.0, 0.0]), name="U",
                   dims=dimVelocity, bcs=tuple(ubcs))
    p = vol_scalar(mesh, 0.0, name="p", dims=DimensionSet.of(0, 2, -2),
                   bcs=tuple(pbcs))
    cfg = piso.PisoConfig(nu=0.01, n_correctors=2)
    state = piso.initial_state(mesh, U, p, project=False)
    step = jax.jit(lambda s, d: piso.piso_step(mesh, s, d, cfg))
    dtv = jnp.asarray(0.01, mesh.v.dtype)
    for _ in range(5):
        state, diag = step(state, dtv)
    assert np.isfinite(np.asarray(state["U"].data)).all()
    assert float(diag["continuity"]) < 2e-5
    # x-momentum decays toward 0 under wall friction but stays periodic:
    # the profile must be x-independent (blockMesh orders cells
    # y-fastest here, so [x, y] = reshape(24, 8); deviation over x tiny)
    Ux = np.asarray(state["U"].data)[:, 0].reshape(24, 8)  # [x, y]
    prof_dev = np.max(np.std(Ux, axis=0)) / max(np.max(np.abs(Ux)), 1e-30)
    assert prof_dev < 2e-5
