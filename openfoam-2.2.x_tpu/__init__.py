"""foamtpu — an unstructured finite-volume CFD framework on JAX/XLA.

A from-scratch rebuild of the capabilities of OpenFOAM-2.2.x
(see SURVEY.md) designed for accelerators:

- Mesh and fields are struct-of-arrays jnp pytrees (no class web).
- fvm/fvc operator algebra assembles LDU-addressed sparse systems
  (reference: src/OpenFOAM/matrices/lduMatrix/) as flat arrays.
- All hot paths are gather-based (cell->face adjacency tables) rather
  than scatter-based, jitted end-to-end by XLA.
- Parallelism is GSPMD/shard_map over a jax device Mesh with ppermute
  halo exchange — the accelerator equivalent of the reference's MPI domain
  decomposition (reference: src/Pstream/mpi/).

Import as ``import foamtpu`` (the ``foamtpu`` symlink points at the
source directory).
"""

__version__ = "0.1.0"

from . import core  # noqa: F401
