"""Precision policy.

The reference is float64 everywhere (scalar = double, reference:
src/OpenFOAM/primitives/Scalar/). The device default here is float32:
every hot kernel (stencil SpMV, face interpolation, Krylov vector
updates) is bound by memory bandwidth, and f32 moves half the bytes of
f64, with care taken in reductions. f64 is native on the GPU; set
FOAMTPU_X64=1 (and jax_enable_x64) for f64 runs, which are the
verification reference. Host-side geometry precompute is always f64.

f32 contractions (the GAMG coarsest-level inverse applied as a
matrix-vector product, gradient and scheme einsums) run at full f32
precision: a GPU may otherwise execute them in TF32, which keeps about
three decimal digits and would degrade every V-cycle. None of them is
large enough for tensor cores to pay, so nothing is lost.
"""

import os

import jax
import numpy as np

jax.config.update("jax_default_matmul_precision", "highest")


def x64_enabled() -> bool:
    return os.environ.get("FOAMTPU_X64", "0") not in ("0", "", "false")


def scalar_np():
    return np.float64 if x64_enabled() else np.float32


def scalar_dtype():
    import jax.numpy as jnp

    return jnp.float64 if x64_enabled() else jnp.float32


label_np = np.int32


def install_fpe_trap() -> bool:
    """sigFpe analogue (reference: src/OSspecific/POSIX/signals/
    sigFpe.C — feenableexcept + FOAM_SIGFPE): FOAMTPU_SIGFPE=1 turns
    on jax_debug_nans so the first NaN-producing primitive raises with
    a traceback instead of silently poisoning the run."""
    if os.environ.get("FOAMTPU_SIGFPE", "0") in ("0", "", "false"):
        return False
    jax.config.update("jax_debug_nans", True)
    return True


install_fpe_trap()
