"""StencilOp.matvec (ops/stencil.py) against a float64 scipy.sparse CSR
product of the same matrix: offsets whose neighbour falls outside the
mesh carry zero coefficients (the st_valid contract of the mesh tables),
so the roll wrap-around must contribute nothing; the COO fallback rows
add their scatter on top."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from foamtpu.ops.stencil import StencilOp


def _problem(n, deltas, n_fb, seed=0):
    rng = np.random.default_rng(seed)
    cells = np.arange(n)
    off = rng.standard_normal((n, len(deltas))).astype(np.float32)
    for m, d in enumerate(deltas):
        off[(cells + d < 0) | (cells + d >= n), m] = 0.0
    fb_c = rng.integers(0, n, n_fb).astype(np.int32)
    fb_n = rng.integers(0, n, n_fb).astype(np.int32)
    fb_v = rng.standard_normal(n_fb).astype(np.float32)
    diag = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    rows = np.concatenate([cells, fb_c] + [cells] * len(deltas))
    cols = np.concatenate([cells, fb_n]
                          + [np.clip(cells + d, 0, n - 1) for d in deltas])
    vals = np.concatenate([diag, fb_v] + [off[:, m]
                                          for m in range(len(deltas))])
    A = sp.csr_matrix((vals.astype(np.float64), (rows, cols)), shape=(n, n))
    op = StencilOp(tuple(deltas), jnp.asarray(off), jnp.asarray(fb_c),
                   jnp.asarray(fb_n), jnp.asarray(fb_v))
    return op, diag, x, A


@pytest.mark.parametrize("n,deltas,n_fb", [
    (1024, (1, -1, 16, -16), 0),
    (160000, (1, -1, 400, -400), 0),
    (5000, (1, -1, 128, -128, 3000, -3000), 64),
])
def test_stencil_matvec_matches_csr(n, deltas, n_fb):
    op, diag, x, A = _problem(n, deltas, n_fb)
    got = np.asarray(op.matvec(jnp.asarray(diag), jnp.asarray(x)),
                     np.float64)
    ref = A @ x.astype(np.float64)
    assert np.max(np.abs(got - ref)) <= 1e-5 * np.max(np.abs(ref))
