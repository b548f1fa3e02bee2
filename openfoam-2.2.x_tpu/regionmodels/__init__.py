"""regionModels — thin regions coupled to the primary mesh.

Rebuild of reference: src/regionModels/
  - regionModel/ + singleLayerRegion/   (the film-region mesh: a 2D FV
    mesh over the faces of a primary-mesh wall patch — the reference
    builds it with extrudeToRegionMesh; here filmmesh.py derives it
    directly from the patch faces, host-side, once)
  - surfaceFilmModels/kinematicSingleLayer + thermoSingleLayer
    (film.py — draining liquid films)
  - pyrolysisModels/reactingOneDim (pyrolysis.py — in-depth 1D solid
    columns under every wall face, vmapped)

Design: region state is a small pytree of [nFace(,k)] arrays; the
film step is explicit upwind surface-FV (edge scatters over a few
thousand faces — negligible next to the primary solve), the pyrolysis
step is a vmapped 1D column integration (pure elementwise work).
"""

from .filmmesh import FilmMesh, build_film_mesh
from .film import FilmConfig, film_init, film_step
from .pyrolysis import PyrolysisConfig, pyro_init, pyro_step

__all__ = [
    "FilmMesh", "build_film_mesh",
    "FilmConfig", "film_init", "film_step",
    "PyrolysisConfig", "pyro_init", "pyro_step",
]
