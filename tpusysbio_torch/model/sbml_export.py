"""SBML export for the port's mass-action networks, its own copy of
``tpusysbio/model/sbml_export.py`` (round trip with ``sbml_import``).

Emits SBML Level 3 core from a :class:`MassActionNetwork`: one species per
network species (initial concentrations from the caller), one global
parameter per reaction (its rate constant, in network order, the order
``p`` takes everywhere) and explicit mass-action kinetic-law MathML
``k_j · Π y_i^R[j,i]``. The network's exponent and stoichiometry tensors
are read off their device once. Ids are sanitized to SBML SIds with
collision suffixes. The document text equals the reference's character
for character for the same network and values.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Union

import numpy as np

from tpusysbio_torch.model.massaction import MassActionNetwork

_SBML_NS = "http://www.sbml.org/sbml/level3/version2/core"
_MATHML_NS = "http://www.w3.org/1998/Math/MathML"


def _sanitize(names: Sequence[str], prefix: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    seen = set()
    for name in names:
        sid = re.sub(r"[^A-Za-z0-9_]", "_", name)
        if not sid or not (sid[0].isalpha() or sid[0] == "_"):
            sid = prefix + sid
        base = sid
        k = 2
        while sid in seen:
            sid = f"{base}_{k}"
            k += 1
        seen.add(sid)
        out[name] = sid
    return out


def _rate_mathml(k_id: str, species_ids, exponents) -> str:
    factors = [f"<ci>{k_id}</ci>"]
    for sid, e in zip(species_ids, exponents):
        if e == 1:
            factors.append(f"<ci>{sid}</ci>")
        elif e > 1:
            factors.append(f"<apply><power/><ci>{sid}</ci>"
                           f"<cn type=\"integer\">{int(e)}</cn></apply>")
    if len(factors) == 1:
        body = factors[0]
    else:
        body = "<apply><times/>" + "".join(factors) + "</apply>"
    return f"<math xmlns=\"{_MATHML_NS}\">{body}</math>"


def to_sbml(net: MassActionNetwork,
            y0: Union[Sequence[float], Dict[str, float]],
            p: Optional[Sequence[float]] = None,
            name: str = "massaction") -> str:
    """Serialize a mass-action network to an SBML document string.

    Args:
      net: the network (species, reaction names, exponents, stoichiometry).
      y0: initial concentrations — array in species order, or a dict by
        species name (missing names default to 0).
      p: rate-constant values in reaction order (default 1.0 each) —
        these become the document's parameter values, so the PEtab/SBML
        consumer starts at the same point.
      name: SBML model id.
    """
    if isinstance(y0, dict):
        unknown = set(y0) - set(net.species)
        if unknown:
            raise ValueError(f"y0 names not in network: {sorted(unknown)}")
        y0_arr = np.asarray([float(y0.get(s, 0.0)) for s in net.species])
    else:
        y0_arr = np.asarray(y0, dtype=float)
        if y0_arr.shape != (net.n_species,):
            raise ValueError(f"y0 must have {net.n_species} entries")
    p_arr = (np.ones(net.n_reactions) if p is None
             else np.asarray(p, dtype=float))
    if p_arr.shape != (net.n_reactions,):
        raise ValueError(f"p must have {net.n_reactions} entries")

    sp_id = _sanitize(net.species, "s_")
    rx_id = _sanitize(net.reaction_names, "r_")
    k_id = {rn: f"k_{rx_id[rn]}" for rn in net.reaction_names}

    lines = [
        '<?xml version="1.0" encoding="UTF-8"?>',
        f'<sbml xmlns="{_SBML_NS}" level="3" version="2">',
        f' <model id="{_sanitize([name], "m_")[name]}">',
        '  <listOfCompartments>',
        '   <compartment id="cell" size="1" constant="true"/>',
        '  </listOfCompartments>',
        '  <listOfSpecies>',
    ]
    for s, v in zip(net.species, y0_arr):
        lines.append(
            f'   <species id="{sp_id[s]}" compartment="cell" '
            f'initialConcentration="{float(v)!r}" boundaryCondition="false" '
            'constant="false"/>')
    lines.append('  </listOfSpecies>')
    lines.append('  <listOfParameters>')
    for rn, v in zip(net.reaction_names, p_arr):
        lines.append(f'   <parameter id="{k_id[rn]}" value="{float(v)!r}" '
                     'constant="true"/>')
    lines.append('  </listOfParameters>')
    lines.append('  <listOfReactions>')
    reactants = net.reactants.cpu().numpy()
    stoich = net.stoich.cpu().numpy()
    for j, rn in enumerate(net.reaction_names):
        R_j = reactants[j]                          # exponents/consumption
        prod_j = stoich[:, j] + R_j                 # products created
        if (prod_j < 0).any():
            raise ValueError(
                f"reaction {rn!r}: net stoichiometry is inconsistent with "
                "elementary mass action (consumption exceeds exponent)")
        lines.append(f'   <reaction id="{rx_id[rn]}" reversible="false">')
        if (R_j > 0).any():
            lines.append('    <listOfReactants>')
            for i in np.nonzero(R_j > 0)[0]:
                lines.append(
                    f'     <speciesReference species="{sp_id[net.species[i]]}"'
                    f' stoichiometry="{int(R_j[i])}" constant="true"/>')
            lines.append('    </listOfReactants>')
        if (prod_j > 0).any():
            lines.append('    <listOfProducts>')
            for i in np.nonzero(prod_j > 0)[0]:
                lines.append(
                    f'     <speciesReference species="{sp_id[net.species[i]]}"'
                    f' stoichiometry="{int(prod_j[i])}" constant="true"/>')
            lines.append('    </listOfProducts>')
        lines.append('    <kineticLaw>')
        sids = [sp_id[net.species[i]] for i in np.nonzero(R_j > 0)[0]]
        exps = [int(R_j[i]) for i in np.nonzero(R_j > 0)[0]]
        lines.append('     ' + _rate_mathml(k_id[rn], sids, exps))
        lines.append('    </kineticLaw>')
        lines.append('   </reaction>')
    lines.append('  </listOfReactions>')
    lines.append(' </model>')
    lines.append('</sbml>')
    return "\n".join(lines) + "\n"
