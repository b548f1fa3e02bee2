"""Combustion model closures — laminar, PaSR, infinitelyFastChemistry.

Rebuild of reference: src/combustionModels/
  - laminar/                   (direct finite-rate integration)
  - PaSR/PaSR.C                (partially-stirred reactor: reaction
                                rates scaled by kappa = (dt+tc)/(dt+tc+tk),
                                tk = Cmix*sqrt(muEff/rho/epsilon))
  - infinitelyFastChemistry/   (mixed-is-burnt: R = (Y-Yeq)/(C*dt))
plus chemistryModel::tc() (src/thermophysicalModels/chemistryModel/
chemistryModel/chemistryModel.C) for the chemical time scale.

Design: the closure is a pure function over whole fields — the
kappa blending and the equilibrium increment are elementwise work
fused into the operator-split chemistry stage; only `laminar`/`PaSR`
pay for the vmapped stiff Rosenbrock integration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax.numpy as jnp

_TINY = 1e-30


def epsilon_of(tstate: Optional[dict]) -> Optional[Any]:
    """Turbulent dissipation rate from a turbulence state dict
    (epsilon directly, or Cmu*k*omega for omega-based models)."""
    if not tstate:
        return None
    if "epsilon" in tstate:
        return tstate["epsilon"].data
    if "omega" in tstate and "k" in tstate:
        return 0.09 * tstate["k"].data * tstate["omega"].data
    return None


@dataclasses.dataclass(frozen=True)
class Combustion:
    """Static combustion-closure config (jit-safe).

    model: 'laminar' | 'PaSR' | 'infinitelyFastChemistry'
    Cmix:  PaSR mixing-time coefficient (reference default 1.0)
    C:     infinitelyFastChemistry rate coefficient (reference: 5.0)
    """

    chem: Any                      # models/chemistry.ChemistryModel
    model: str = "laminar"
    Cmix: float = 1.0
    C: float = 5.0

    # -- chemical time scale (reference: chemistryModel::tc) -----------------
    def tc(self, c, T):
        """Per-cell chemical time [nC]: total concentration over the
        summed forward consumption rate (the reference's forward-rate
        form, chemistryModel.C tc())."""
        chem = self.chem
        Tc = jnp.maximum(T, 1e-3)
        kf = chem.A[None, :] * Tc[:, None] ** chem.beta[None, :] * \
            jnp.exp(-chem.Ta[None, :] / Tc[:, None])        # [nC,nR]
        logc = jnp.log(jnp.maximum(c, 1e-20))               # [nC,nS]
        rate = kf * jnp.exp(logc @ chem.lhs.T)              # [nC,nR]
        nu_rhs = jnp.sum(chem.rhs, axis=1)                  # [nR]
        denom = rate @ nu_rhs                               # [nC]
        csum = jnp.sum(jnp.maximum(c, 0.0), axis=1)
        return csum / jnp.maximum(denom, _TINY)

    # -- the closure ---------------------------------------------------------
    def advance(self, c, T, dt, rtol=1e-4, epsilon=None, nu_eff=None):
        """Advance concentrations c [nC,nS] over dt under the selected
        closure; returns c_new. epsilon/nu_eff feed the PaSR mixing
        time (both [nC] or None -> kappa=1, laminar fallback)."""
        if self.model == "infinitelyFastChemistry":
            return self._infinitely_fast(c, dt)
        c_lam = self.chem.solve(c, T, dt, rtol=rtol)
        if self.model == "PaSR" and epsilon is not None \
                and nu_eff is not None:
            # kappa = (dt + tc) / (dt + tc + tk)  (reference: PaSR.C
            # correct(); tk = Cmix sqrt(nuEff/epsilon))
            tc = self.tc(c, T)
            tk = self.Cmix * jnp.sqrt(
                jnp.maximum(nu_eff, 0.0)
                / jnp.maximum(epsilon, _TINY))
            kappa = (dt + tc) / (dt + tc + tk)
            return c + kappa[:, None] * (c_lam - c)
        return c_lam

    def _infinitely_fast(self, c, dt):
        """Mixed-is-burnt over the FIRST reaction: the deficient
        reactant is consumed toward equilibrium with relaxation 1/C
        (reference: infinitelyFastChemistry.C — R = (Y - Yeq)/(C*dt),
        integrated over one dt -> dc = (c_eq - c)/C)."""
        chem = self.chem
        lhs, rhs = chem.lhs[0], chem.rhs[0]     # [nS]
        # extent of reaction limited by the deficient reactant
        with_r = lhs > 0.0
        ext = jnp.min(
            jnp.where(with_r[None, :],
                      jnp.maximum(c, 0.0) / jnp.maximum(lhs, _TINY)[None, :],
                      jnp.inf), axis=1)         # [nC]
        c_eq = c + ext[:, None] * (rhs - lhs)[None, :]
        return c + (c_eq - c) / self.C


def from_dict(props, chem) -> Combustion:
    """Build from a constant/combustionProperties dictionary
    (reference: combustionModel::New — `combustionModel
    PaSR<psiChemistryCombustion>;` + <model>Coeffs sub-dict)."""
    raw = str(props.get("combustionModel", "laminar")).strip()
    name = raw.split("<")[0].strip()
    kw = {}
    coeffs = props.get(name + "Coeffs", {}) or {}
    if name == "PaSR":
        kw["Cmix"] = float(coeffs.get("Cmix", 1.0))
    elif name == "infinitelyFastChemistry":
        kw["C"] = float(coeffs.get("C", 5.0))
    elif name not in ("laminar",):
        name = "laminar"   # unknown closures fall back (documented)
    return Combustion(chem=chem, model=name, **kw)
