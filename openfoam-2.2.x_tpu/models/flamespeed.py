"""Laminar flame-speed correlations for the b-Xi combustion family.

Rebuild of reference: src/thermophysicalModels/laminarFlameSpeed/
  - constant/constant.C            (fixed Su)
  - Gulders/Gulders.C              (Gulder 1984 correlation:
        Su0 = W phi^eta exp(-xi (phi-1.075)^2)
              * (Tu/Tref)^alpha * (p/pref)^beta,
        Tref = 300 K, pref = 1.013e5 Pa, with built-in fuel
        coefficient sets for Methane/Propane/IsoOctane)
  - GuldersEGR/GuldersEGR.C        (same, derated by trapped residual
        mass fraction: * (1 - 2.1 Yres))
  - RaviPetersen/RaviPetersen.C    (hydrogen: piecewise polynomials of
        the equivalence ratio, interpolated across pressure intervals,
        with a temperature exponent polynomial per interval)

Design: a correlation is a pure elementwise function Su(p, Tu)
over whole fields — closed over static fuel coefficients so it fuses
into the XiFoam step; the RaviPetersen pressure-interval selection is
a static-table jnp.searchsorted (no data-dependent control flow).
The equivalence ratio is the homogeneous-charge value from the
dictionary (reference: XiFoam's SuModel `unstrained` evaluates the
correlation at the dictionary phi when no ft field is transported).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax.numpy as jnp
import numpy as np

# Gulder fuel coefficient sets (reference: Gulders.C constructor table)
_GULDER_FUELS = {
    "Methane":   dict(W=0.422,  eta=0.15,   xi=5.18, alpha=2.00, beta=-0.5),
    "Propane":   dict(W=0.446,  eta=0.12,   xi=4.95, alpha=1.77, beta=-0.2),
    "IsoOctane": dict(W=0.4658, eta=-0.326, xi=4.48, alpha=1.56, beta=-0.22),
}
_T_REF = 300.0
_P_REF = 1.013e5


def _gulder_su(coeffs: dict, phi: float, egr: float = 0.0
               ) -> Callable[[Any, Any], Any]:
    W, eta, xi = coeffs["W"], coeffs["eta"], coeffs["xi"]
    alpha, beta = coeffs["alpha"], coeffs["beta"]
    su_ref = W * phi ** eta * np.exp(-xi * (phi - 1.075) ** 2)
    derate = max(1.0 - 2.1 * egr, 0.0)   # GuldersEGR.C: (1 - 2.1 Yres)

    def su(p, Tu):
        return (su_ref * derate
                * (Tu / _T_REF) ** alpha
                * (jnp.maximum(p, 1e3) / _P_REF) ** beta)

    return su


def _poly_eval(coeffs: np.ndarray, x: Any) -> Any:
    """sum_i c_i x^i with static numpy coefficients (ascending order,
    the reference's polynomial table convention)."""
    acc = jnp.zeros_like(x) + coeffs[-1]
    for c in coeffs[-2::-1]:
        acc = acc * x + c
    return acc


def _ravi_petersen(coeffs, phi: float) -> Callable[[Any, Any], Any]:
    """RaviPetersen.C: Su = su_p(phi) * (Tu/Tref)^alpha_p(phi), where
    su/alpha are per-pressure-interval polynomials in phi, linearly
    interpolated between the bracketing pPoints pressures."""
    p_pts = np.asarray([float(v) for v in coeffs["pPoints"]])
    eqr_pts = np.asarray([float(v) for v in coeffs["EqRPoints"]])
    t_ref = float(coeffs.get("TRef", 320.0))

    def _table(key):
        # table[i][j] = polynomial coeffs for EqR interval i, pressure j
        raw = coeffs[key]
        return [[np.asarray([float(c) for c in poly]) for poly in row]
                for row in raw]

    alpha_tab = _table("alpha")
    beta_tab = _table("beta")
    # static equivalence-ratio interval (phi is a dictionary constant)
    i = int(np.clip(np.searchsorted(eqr_pts, phi) - 1, 0,
                    len(alpha_tab) - 1))
    su_polys = [alpha_tab[i][j] for j in range(len(p_pts))]
    ex_polys = [beta_tab[i][j] for j in range(len(p_pts))]

    def su(p, Tu):
        p = jnp.asarray(p)
        su_j = jnp.stack([_poly_eval(c, jnp.full_like(p, phi))
                          for c in su_polys])       # [nP, ...]
        ex_j = jnp.stack([_poly_eval(c, jnp.full_like(p, phi))
                          for c in ex_polys])
        pj = jnp.asarray(p_pts, p.dtype)
        j = jnp.clip(jnp.searchsorted(pj, p) - 1, 0, len(p_pts) - 2)
        w = (p - pj[j]) / (pj[j + 1] - pj[j])
        w = jnp.clip(w, 0.0, 1.0)
        su_lo = jnp.take_along_axis(su_j, j[None], axis=0)[0]
        su_hi = jnp.take_along_axis(su_j, (j + 1)[None], axis=0)[0]
        ex_lo = jnp.take_along_axis(ex_j, j[None], axis=0)[0]
        ex_hi = jnp.take_along_axis(ex_j, (j + 1)[None], axis=0)[0]
        su0 = (1.0 - w) * su_lo + w * su_hi
        ex = (1.0 - w) * ex_lo + w * ex_hi
        return jnp.maximum(su0, 0.0) * (Tu / t_ref) ** ex

    return su


def make_flame_speed(comb: dict, su_default: float = 0.4
                     ) -> Optional[Callable[[Any, Any], Any]]:
    """Build Su(p, Tu) from a combustionProperties dictionary
    (reference: laminarFlameSpeed::New — keyword
    `laminarFlameSpeedCorrelation`; `fuel` selects the Gulder
    coefficient set; fuel-specific <Fuel>Coeffs sub-dicts override).
    Returns None for `constant` (the caller keeps its scalar path)."""
    name = str(comb.get("laminarFlameSpeedCorrelation",
                        "constant")).strip()
    if name in ("constant", "", "unstrained"):
        return None
    phi = float(comb.get("equivalenceRatio", 1.0))
    fuel = str(comb.get("fuel", "Methane")).strip()
    if name == "RaviPetersen":
        coeffs = comb.get(fuel + "Coeffs", comb.get("RaviPetersenCoeffs"))
        if coeffs is None:
            raise ValueError("RaviPetersen needs a coefficients sub-dict")
        return _ravi_petersen(coeffs, phi)
    if name in ("Gulders", "GuldersEGR"):
        base = dict(_GULDER_FUELS.get(fuel, _GULDER_FUELS["Methane"]))
        over = comb.get(fuel + "Coeffs", {}) or {}
        for k in base:
            if k in over:
                base[k] = float(over[k])
        egr = float(comb.get("EGR", comb.get("Yres", 0.0))) \
            if name == "GuldersEGR" else 0.0
        return _gulder_su(base, phi, egr)
    raise ValueError(f"unknown laminarFlameSpeedCorrelation '{name}'")
