"""Finite-rate chemistry — Arrhenius reaction sets integrated per cell.

Rebuild of reference: src/thermophysicalModels/chemistryModel/
(chemistryModel::omega, solve — the stiff per-cell ODE integration of
reaction sources) and src/combustionModels/infinitelyFastChemistry.
Redesign: the reference loops cells and calls a sequential ODE
solver per cell; here the WHOLE field of cell states integrates as one
`jax.vmap` of the Rosenbrock solver (foamtpu.ode) — one fused device
program, no per-cell host dispatch.

Species state is molar concentration c [kmol/m^3]; reactions are
irreversible Arrhenius k = A T^beta exp(-Ta/T) with integer (or real)
stoichiometry. Heat release couples back through the species formation
enthalpies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import ode


class Reaction(NamedTuple):
    """lhs/rhs: stoichiometric coefficient per species (dense [nS])."""
    lhs: Any           # [nS] reactant orders/coefficients
    rhs: Any           # [nS] product coefficients
    A: float           # pre-exponential
    beta: float        # temperature exponent
    Ta: float          # activation temperature [K]


@dataclasses.dataclass(frozen=True)
class ChemistryModel:
    """An immutable reaction mechanism over nS species."""

    species: Tuple[str, ...]
    lhs: Any           # [nR, nS]
    rhs: Any           # [nR, nS]
    A: Any             # [nR]
    beta: Any          # [nR]
    Ta: Any            # [nR]
    hf: Any            # [nS] formation enthalpy [J/kmol] (heat release)

    @staticmethod
    def build(species: Sequence[str], reactions: Sequence[Dict],
              hf: Optional[Sequence[float]] = None) -> "ChemistryModel":
        ns = len(species)
        idx = {s: i for i, s in enumerate(species)}
        L = np.zeros((len(reactions), ns))
        R = np.zeros((len(reactions), ns))
        A, beta, Ta = [], [], []
        for r, spec in enumerate(reactions):
            for name, coef in spec["lhs"]:
                L[r, idx[name]] += coef
            for name, coef in spec["rhs"]:
                R[r, idx[name]] += coef
            A.append(float(spec["A"]))
            beta.append(float(spec.get("beta", 0.0)))
            Ta.append(float(spec.get("Ta", 0.0)))
        return ChemistryModel(
            species=tuple(species),
            lhs=jnp.asarray(L), rhs=jnp.asarray(R),
            A=jnp.asarray(np.asarray(A)),
            beta=jnp.asarray(np.asarray(beta)),
            Ta=jnp.asarray(np.asarray(Ta)),
            hf=jnp.asarray(np.zeros(ns) if hf is None
                           else np.asarray(hf, dtype=float)))

    # -- reaction rates ------------------------------------------------------
    def k(self, T):
        """Arrhenius rate constants [nR]."""
        T = jnp.maximum(T, 1e-3)
        return self.A * T ** self.beta * jnp.exp(-self.Ta / T)

    def omega(self, c, T):
        """dc/dt [nS] for one cell state (c [nS], T scalar)
        (reference: chemistryModel::omega)."""
        kf = self.k(T)
        cs = jnp.maximum(c, 0.0)
        # rate_r = k_r * prod_s c_s^lhs_rs; the floor must stay inside
        # f32 range (log(1e-300) is -inf in f32 and 0*inf = NaN)
        logc = jnp.log(jnp.maximum(cs, 1e-20))
        rate = kf * jnp.exp(self.lhs @ logc)
        return (self.rhs - self.lhs).T @ rate

    def heat_release(self, c, T):
        """-sum_s hf_s * dc_s/dt [J/m^3/s] for one cell."""
        return -jnp.dot(self.hf, self.omega(c, T))

    # -- stiff integration (the chemistry `solve`) ---------------------------
    def solve(self, c_field, T_field, dt, rtol=1e-6, atol=1e-12):
        """Integrate every cell's concentrations over dt with the
        Rosenbrock solver, vmapped (reference: chemistryModel::solve
        looping cells with the selected ODESolver). T frozen over the
        sub-step (segregated coupling, as the reference)."""

        def one(c, T):
            f = lambda t, y: self.omega(y, T)
            return ode.integrate(f, c, 0.0, dt, solver="rodas23",
                                 rtol=rtol, atol=atol).y

        return jax.vmap(one)(c_field, T_field)


# ---------------------------------------------------------------------------
# foamChemistry-format mechanism reader
# (reference: src/thermophysicalModels/reactionThermo/chemistryReaders/
#  foamChemistryReader/ — `species (...)` + `reactions { ... }` dicts,
#  thermo data from a thermo.compressibleGas-style dictionary)
# ---------------------------------------------------------------------------

_R_UNIV = 8314.47  # J/(kmol K)


def parse_reaction(s: str) -> Tuple[List[Tuple[str, float]],
                                    List[Tuple[str, float]]]:
    """Parse a reaction equation string "CH4 + 2O2 = CO2 + 2H2O" into
    (lhs, rhs) stoichiometric lists (reference: Reaction::setLRhs).
    Coefficients may be real ("0.5O2"); "^" exponents are not
    supported (documented deviation)."""
    import re

    def side(txt):
        out = []
        for term in txt.split("+"):
            term = term.strip()
            if not term:
                continue
            m = re.match(r"^([\d.]*)\s*([A-Za-z(][\w()\-+,*']*)$", term)
            if not m:
                raise ValueError(f"cannot parse reaction term {term!r}")
            coef = float(m.group(1)) if m.group(1) else 1.0
            out.append((m.group(2), coef))
        return out

    lhs_txt, rhs_txt = s.split("=")
    return side(lhs_txt), side(rhs_txt)


def _species_hf(entry) -> Tuple[float, float]:
    """(molWeight, formation enthalpy [J/kmol]) from a species thermo
    entry: janaf NASA-7 evaluated at Tstd=298.15 (reference:
    janafThermo::Hc) or an hConst `Hf` [J/kg] entry."""
    spec = entry.get("specie", {})
    W = float(spec.get("molWeight", 28.96))
    th = entry.get("thermodynamics", {})
    if "Hf" in th:
        return W, float(th["Hf"]) * W
    lo = [float(x) for x in th.get("lowCpCoeffs", [])]
    if len(lo) >= 6:
        T = 298.15
        h_RT = (lo[0] + lo[1] * T / 2 + lo[2] * T ** 2 / 3
                + lo[3] * T ** 3 / 4 + lo[4] * T ** 4 / 5 + lo[5] / T)
        return W, h_RT * _R_UNIV * T
    return W, 0.0


def from_foam_files(reactions_dict, thermo_dict=None):
    """Build (ChemistryModel, W [nS]) from parsed `constant/reactions` +
    `constant/thermo.compressibleGas` dictionaries."""
    species = [str(s) for s in reactions_dict["species"]]
    rxns = []
    rsec = reactions_dict.get("reactions", {})
    for name, spec in (rsec.items() if hasattr(rsec, "items") else []):
        if not hasattr(spec, "get"):
            continue
        eq = str(spec.get("reaction", "")).strip().strip('"')
        if not eq:
            continue
        lhs, rhs = parse_reaction(eq)
        rxns.append({"lhs": lhs, "rhs": rhs,
                     "A": float(spec.get("A", 1.0)),
                     "beta": float(spec.get("beta", 0.0)),
                     "Ta": float(spec.get("Ta", 0.0))})
    W = np.full(len(species), 28.96)
    hf = np.zeros(len(species))
    if thermo_dict is not None:
        for i, s in enumerate(species):
            if s in thermo_dict:
                W[i], hf[i] = _species_hf(thermo_dict[s])
    model = ChemistryModel.build(species, rxns, hf=hf)
    return model, W
