"""The device precision policy (core/precision.py): f32 contractions run
at full precision wherever the package is imported, so the GAMG
coarsest-level solve, an explicit inverse applied as a matrix-vector
product, keeps its f32 accuracy (a TF32 product would not). The
residual is the one chip_smoke.py's kernel phase checks on the card."""

import jax

import chip_smoke
import foamtpu  # noqa: F401  (installs the policy)


def test_matmul_precision_is_highest():
    assert jax.config.jax_default_matmul_precision == "highest"


def test_coarsest_dense_solve_residual_f32():
    res, _ = chip_smoke.coarse_solve_residual(1024)
    assert res <= chip_smoke.COARSE_RTOL, res
