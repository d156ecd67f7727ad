"""SBML → batched PyTorch model import, the port's own copy of
``tpusysbio/model/sbml_import.py`` (stdlib XML; no libsbml).

The parser is the reference's: ``xml.etree.ElementTree`` reads SBML core
(Level 2 and 3), content MathML becomes SymPy expressions, and the result
goes through the port's :func:`tpusysbio_torch.model.sympy_import.
from_sympy`, so the model's RHS is a batched torch function whose
Jacobian and sensitivities come from forward-mode AD.

Supported subset (everything else raises ``SbmlUnsupportedError`` rather
than mis-simulating): constant compartments; species with initial amounts
or concentrations, ``boundaryCondition``/``constant``/
``hasOnlySubstanceUnits``; global parameters; local (kineticLaw)
parameters, lifted to ``<reactionId>__<paramId>``; reactions with constant
stoichiometry; functionDefinitions (inlined); assignmentRules
(substituted) and rateRules (a parameter so ruled becomes a state);
initialAssignments; MathML arithmetic, power/root, exp/ln/log,
abs/floor/ceiling, trigonometry, min/max, piecewise with relations and
logic, ``<csymbol>`` time, numeric ``<cn>`` forms.

Events: ``events="raise"`` (default) raises on any ``<event>``;
``events="lower"`` lowers constant-time triggers (``time >= c``) with
constant assignments to ``(kind, time, target, value)`` records for
``Experiment.inputs`` (parameters) and ``Experiment.input_states``
(species). State-dependent triggers, parameter-dependent times,
non-constant assignments and delays raise.

Species symbols in MathML mean concentrations unless
``hasOnlySubstanceUnits``; kinetic laws are substance/time and the ODEs
divide by the compartment size. Model parameters, in order: global
constant parameters, lifted local parameters, boundary/constant species.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import sympy as sp

from tpusysbio_torch.model.core import OdeModel
from tpusysbio_torch.model.sympy_import import from_sympy


class SbmlError(ValueError):
    """Malformed SBML (missing ids, unknown symbols, bad MathML)."""


class SbmlUnsupportedError(SbmlError):
    """Valid SBML using a construct outside the supported core subset."""


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _children(node, name):
    return [c for c in node if _strip_ns(c.tag) == name]


def _find(node, name):
    got = _children(node, name)
    return got[0] if got else None


def _list_of(node, plural, singular):
    wrap = _find(node, plural)
    return _children(wrap, singular) if wrap is not None else []


_TIME_URL = "time"  # definitionURL ends with .../symbols/time


class _MathML:
    """Content-MathML → SymPy, with functionDefinition inlining."""

    _BINARY_LEFT = {"minus": lambda a, b: a - b,
                    "divide": lambda a, b: a / b}
    _NARY = {"plus": lambda *a: sp.Add(*a),
             "times": lambda *a: sp.Mul(*a)}
    _FUNCS = {"exp": sp.exp, "ln": sp.log, "abs": sp.Abs,
              "floor": sp.floor, "ceiling": sp.ceiling,
              "sin": sp.sin, "cos": sp.cos, "tan": sp.tan,
              "arcsin": sp.asin, "arccos": sp.acos, "arctan": sp.atan,
              "sinh": sp.sinh, "cosh": sp.cosh, "tanh": sp.tanh}
    _RELATIONS = {"lt": sp.Lt, "leq": sp.Le, "gt": sp.Gt, "geq": sp.Ge,
                  "eq": sp.Eq, "neq": sp.Ne}
    _LOGIC = {"and": sp.And, "or": sp.Or, "not": sp.Not}

    def __init__(self, symbols: Dict[str, sp.Expr], t_sym: sp.Symbol,
                 fundefs: Dict[str, tuple]):
        self.symbols = symbols
        self.t = t_sym
        self.fundefs = fundefs

    def parse_container(self, math_node) -> sp.Expr:
        kids = list(math_node)
        if len(kids) != 1:
            raise SbmlError("<math> must contain exactly one expression")
        return self.parse(kids[0])

    def parse(self, node) -> sp.Expr:
        tag = _strip_ns(node.tag)
        if tag == "ci":
            name = (node.text or "").strip()
            if name not in self.symbols:
                raise SbmlError(f"unknown identifier in MathML: {name!r}")
            return self.symbols[name]
        if tag == "cn":
            return self._number(node)
        if tag == "csymbol":
            url = node.get("definitionURL", "")
            if url.endswith(_TIME_URL):
                return self.t
            raise SbmlUnsupportedError(f"csymbol {url!r} (e.g. delay)")
        if tag == "apply":
            return self._apply(node)
        if tag == "piecewise":
            return self._piecewise(node)
        if tag in ("true", "false"):
            return sp.true if tag == "true" else sp.false
        if tag == "pi":
            return sp.pi
        if tag == "exponentiale":
            return sp.E
        if tag == "notanumber":
            return sp.nan
        if tag == "infinity":
            return sp.oo
        raise SbmlUnsupportedError(f"MathML element <{tag}>")

    def _number(self, node) -> sp.Expr:
        ty = node.get("type", "real")
        if ty in ("e-notation", "rational"):
            sep = _find(node, "sep")
            head = (node.text or "").strip()
            tail = (sep.tail or "").strip() if sep is not None else "0"
            if ty == "e-notation":
                return sp.Float(f"{head}e{tail}")
            return sp.Rational(int(head), int(tail))
        text = (node.text or "").strip()
        if ty == "integer":
            return sp.Integer(int(text))
        return sp.Float(text)

    def _apply(self, node) -> sp.Expr:
        kids = list(node)
        if not kids:
            raise SbmlError("empty <apply>")
        op = _strip_ns(kids[0].tag)
        # <degree>/<logbase> are qualifiers of root/log, not arguments
        args = [self.parse(k) for k in kids[1:]
                if _strip_ns(k.tag) not in ("degree", "logbase")]

        if op == "ci":  # user functionDefinition call
            name = (kids[0].text or "").strip()
            if name not in self.fundefs:
                raise SbmlError(f"call of unknown function {name!r}")
            argnames, body = self.fundefs[name]
            if len(args) != len(argnames):
                raise SbmlError(f"function {name!r} arity mismatch")
            return body.xreplace(dict(zip(argnames, args)))
        if op in self._NARY:
            return self._NARY[op](*args)
        if op == "minus":
            return -args[0] if len(args) == 1 else args[0] - args[1]
        if op == "divide":
            return args[0] / args[1]
        if op == "power":
            return args[0] ** args[1]
        if op == "root":
            degree = _find(node, "degree")
            if degree is not None:
                deg = self.parse(list(degree)[0])
                operand = args[-1]
                return operand ** (sp.Integer(1) / deg)
            return sp.sqrt(args[0])
        if op == "log":
            logbase = _find(node, "logbase")
            if logbase is not None:
                base = self.parse(list(logbase)[0])
                return sp.log(args[-1], base)
            return sp.log(args[0], 10)
        if op in self._FUNCS:
            return self._FUNCS[op](args[0])
        if op in ("min", "max"):
            return (sp.Min if op == "min" else sp.Max)(*args)
        if op in self._RELATIONS:
            return self._RELATIONS[op](*args)
        if op in self._LOGIC:
            return self._LOGIC[op](*args)
        if op == "delay":
            raise SbmlUnsupportedError("delay differential equations")
        raise SbmlUnsupportedError(f"MathML operator <{op}>")

    def _piecewise(self, node) -> sp.Expr:
        pairs = []
        for piece in _children(node, "piece"):
            kids = list(piece)
            if len(kids) != 2:
                raise SbmlError("<piece> needs value + condition")
            pairs.append((self.parse(kids[0]), self.parse(kids[1])))
        other = _find(node, "otherwise")
        if other is not None:
            pairs.append((self.parse(list(other)[0]), sp.true))
        return sp.Piecewise(*pairs)


def from_sbml(source: str, name: Optional[str] = None,
              events: str = "raise") -> OdeModel:
    """Build an :class:`OdeModel` from an SBML document.

    Args:
      source: path to an ``.xml``/``.sbml`` file, or the document text
        itself (detected by a leading ``<``).
      name: model name override (defaults to the SBML model id).
      events: ``"raise"`` (default — any ``<event>`` raises) or
        ``"lower"`` — events with constant-time triggers and constant
        assignments are lowered to timed-input records (see below);
        anything else still raises.

    Returns:
      ``(model, p0)`` — or ``(model, p0, lowered)`` with
      ``events="lower"``, where ``lowered`` is a tuple of
      ``(kind, time, target_id, value)`` records, ``kind`` ``"param"``
      (→ ``Experiment.inputs``) or ``"state"``
      (→ ``Experiment.input_states``). The ``OdeModel``'s parameter
      vector is ``global params + lifted local params + boundary/constant
      species`` in document order (see module docstring), with
      ``param_names``/``state_names`` recording the SBML ids, and ``p0``
      the declared parameter values (the natural fit start).
    """
    if events not in ("raise", "lower"):
        raise ValueError(f"events must be 'raise' or 'lower', got "
                         f"{events!r}")
    text = source
    if not source.lstrip().startswith("<"):
        if not os.path.exists(source):
            raise FileNotFoundError(source)
        with open(source) as fh:
            text = fh.read()
    root = ET.fromstring(text)
    if _strip_ns(root.tag) != "sbml":
        raise SbmlError("not an SBML document (root is not <sbml>)")
    model_node = _find(root, "model")
    if model_node is None:
        raise SbmlError("SBML document has no <model>")
    model_id = name or model_node.get("id") or model_node.get("name") or "sbml"

    event_nodes = _list_of(model_node, "listOfEvents", "event")
    if event_nodes and events == "raise":
        raise SbmlUnsupportedError(
            "SBML events — pass events='lower' to auto-lower constant-"
            "time triggers onto Experiment timed inputs, or express "
            "dose/stimulus protocols with tpusysbio_torch.data.Experiment "
            "timed inputs directly")

    t_sym = sp.Symbol("t")

    # ---- compartments -------------------------------------------------
    comp_size: Dict[str, float] = {}
    for c in _list_of(model_node, "listOfCompartments", "compartment"):
        cid = c.get("id")
        if c.get("constant", "true") == "false":
            raise SbmlUnsupportedError(f"non-constant compartment {cid!r}")
        comp_size[cid] = float(c.get("size", c.get("volume", "1.0")))

    # ---- species ------------------------------------------------------
    species: List[dict] = []
    for s in _list_of(model_node, "listOfSpecies", "species"):
        sid = s.get("id")
        if sid is None:
            raise SbmlError("species without id")
        amt, conc = s.get("initialAmount"), s.get("initialConcentration")
        vol = comp_size.get(s.get("compartment"), 1.0)
        substance_units = s.get("hasOnlySubstanceUnits", "false") == "true"
        if amt is not None:
            init = float(amt) if substance_units else float(amt) / vol
        elif conc is not None:
            init = float(conc) * vol if substance_units else float(conc)
        else:
            init = 0.0  # may be set by initialAssignment below
        species.append({
            "id": sid, "init": sp.Float(init), "vol": vol,
            "substance": substance_units,
            "constant": s.get("constant", "false") == "true",
            "fixed": (s.get("boundaryCondition", "false") == "true"
                      or s.get("constant", "false") == "true"),
        })
    spec_by_id = {s["id"]: s for s in species}

    # ---- symbols table ------------------------------------------------
    symbols: Dict[str, sp.Expr] = {"t": t_sym, "time": t_sym}
    for cid, size in comp_size.items():
        symbols[cid] = sp.Float(size)
    for s in species:
        s["sym"] = sp.Symbol(s["id"])
        symbols[s["id"]] = s["sym"]

    global_params: List[tuple] = []  # (id, value, constant)
    for p in _list_of(model_node, "listOfParameters", "parameter"):
        pid = p.get("id")
        val = float(p.get("value", "nan") or "nan")
        const = p.get("constant", "true") != "false"
        symbols[pid] = sp.Symbol(pid)
        global_params.append((pid, val, const))

    # ---- function definitions (lambda bodies, inlined on use) ---------
    fundefs: Dict[str, tuple] = {}
    for f in _list_of(model_node, "listOfFunctionDefinitions",
                      "functionDefinition"):
        fid = f.get("id")
        math = _find(f, "math")
        lam = list(math)[0]
        if _strip_ns(lam.tag) != "lambda":
            raise SbmlError(f"functionDefinition {fid!r} without <lambda>")
        argnames, body_node = [], None
        for kid in lam:
            if _strip_ns(kid.tag) == "bvar":
                argnames.append(sp.Symbol((list(kid)[0].text or "").strip()))
            else:
                body_node = kid
        local_syms = {str(a): a for a in argnames}
        parser = _MathML({**symbols, **local_syms}, t_sym, fundefs)
        fundefs[fid] = (argnames, parser.parse(body_node))

    mathml = _MathML(symbols, t_sym, fundefs)

    # ---- rules ---------------------------------------------------------
    assignments: Dict[sp.Symbol, sp.Expr] = {}
    rate_rules: Dict[str, sp.Expr] = {}
    rules_wrap = _find(model_node, "listOfRules")
    for r in (list(rules_wrap) if rules_wrap is not None else []):
        tag = _strip_ns(r.tag)
        math = _find(r, "math")
        if tag == "assignmentRule":
            var = r.get("variable")
            assignments[symbols[var]] = mathml.parse_container(math)
        elif tag == "rateRule":
            rate_rules[r.get("variable")] = mathml.parse_container(math)
        else:
            raise SbmlUnsupportedError(f"{tag} (algebraic rules)")

    # resolve assignment-rule chains (bounded depth)
    for _ in range(len(assignments) + 1):
        changed = False
        for k, v in assignments.items():
            nv = v.xreplace(assignments)
            if nv != v:
                assignments[k] = nv
                changed = True
        if not changed:
            break
    else:
        raise SbmlError("cyclic assignment rules")

    # ---- initial assignments -------------------------------------------
    init_assign: Dict[str, sp.Expr] = {}
    for ia in _list_of(model_node, "listOfInitialAssignments",
                       "initialAssignment"):
        init_assign[ia.get("symbol")] = mathml.parse_container(
            _find(ia, "math"))

    # ---- reactions → rate expressions ----------------------------------
    local_params: List[tuple] = []  # (lifted_id, value)
    net_rate: Dict[str, sp.Expr] = {s["id"]: sp.Integer(0) for s in species}
    for rxn in _list_of(model_node, "listOfReactions", "reaction"):
        rid = rxn.get("id") or f"r{len(local_params)}"
        kl = _find(rxn, "kineticLaw")
        if kl is None:
            raise SbmlUnsupportedError(f"reaction {rid!r} has no kineticLaw")
        # lift local parameters: SBML scopes them to the kineticLaw
        local_syms = {}
        for lp in (_list_of(kl, "listOfParameters", "parameter")
                   + _list_of(kl, "listOfLocalParameters", "localParameter")):
            pid = lp.get("id")
            lifted = f"{rid}__{pid}"
            sym = sp.Symbol(lifted)
            local_syms[pid] = sym
            local_params.append((lifted, float(lp.get("value", "nan"))))
            symbols[lifted] = sym
        parser = _MathML({**symbols, **local_syms}, t_sym, fundefs)
        rate = parser.parse_container(_find(kl, "math"))

        for kind, sign in (("listOfReactants", -1), ("listOfProducts", +1)):
            for ref in _list_of(rxn, kind, "speciesReference"):
                if _find(ref, "stoichiometryMath") is not None:
                    raise SbmlUnsupportedError("stoichiometryMath")
                sid = ref.get("species")
                if sid not in spec_by_id:
                    raise SbmlError(f"reaction {rid!r} references unknown "
                                    f"species {sid!r}")
                stoich = sp.Float(float(ref.get("stoichiometry", "1")))
                net_rate[sid] = net_rate[sid] + sign * stoich * rate

    # ---- classify: states vs parameters --------------------------------
    # species symbol in MathML means concentration unless substance-only;
    # our state holds the same native form, so no symbol rewrite is needed.
    # A boundaryCondition species targeted by a rateRule is a STATE (SBML:
    # boundary species change via rules, not reactions); rules on
    # constant="true" entities are invalid SBML and rejected.
    for s in species:
        if s["constant"] and (s["id"] in rate_rules
                              or s["sym"] in assignments):
            raise SbmlError(f"rule targets constant species {s['id']!r}")
    state_species = [s for s in species
                     if (s["id"] in rate_rules or not s["fixed"])
                     and s["sym"] not in assignments]
    param_ids: List[str] = []
    param_vals: List[float] = []
    for pid, val, const in global_params:
        ruled = pid in rate_rules or symbols[pid] in assignments
        if const and ruled:
            raise SbmlError(f"rule targets constant parameter {pid!r}")
        if ruled:
            continue  # becomes a state / derived expression below
        param_ids.append(pid)
        param_vals.append(val)
    for pid, val in local_params:
        param_ids.append(pid)
        param_vals.append(val)
    for s in species:
        if (s["fixed"] and s["id"] not in rate_rules
                and s["sym"] not in assignments):
            param_ids.append(s["id"])
            init = init_assign.get(s["id"], s["init"])
            if isinstance(init, sp.Expr) and init.free_symbols:
                raise SbmlUnsupportedError(
                    f"fixed species {s['id']!r} with symbolic initial value")
            param_vals.append(float(init))

    # non-constant parameters driven by rateRules become states
    rate_rule_params = [pid for pid in rate_rules if pid not in spec_by_id]

    states = [s["sym"] for s in state_species]
    states += [symbols[pid] for pid in rate_rule_params]
    params = [symbols[pid] for pid in param_ids]

    odes: List[sp.Expr] = []
    for s in state_species:
        if s["id"] in rate_rules:
            expr = rate_rules[s["id"]]
        else:
            expr = net_rate[s["id"]]  # substance/time
            if not s["substance"] and s["vol"] != 1.0:
                expr = expr / sp.Float(s["vol"])
        odes.append(expr.xreplace(assignments))
    for pid in rate_rule_params:
        odes.append(rate_rules[pid].xreplace(assignments))

    y0_exprs: List[sp.Expr] = []
    for s in state_species:
        init = init_assign.get(s["id"], s["init"])
        y0_exprs.append(sp.sympify(init).xreplace(assignments))
    for pid in rate_rule_params:
        val = dict((p, v) for p, v, _ in global_params).get(pid, 0.0)
        init = init_assign.get(pid, sp.Float(val))
        y0_exprs.append(sp.sympify(init).xreplace(assignments))

    # sanity: every symbol left in the ODEs must be a state, param, or t
    allowed = set(states) | set(params) | {t_sym}
    for expr, st in zip(odes, states):
        extra = expr.free_symbols - allowed
        if extra:
            raise SbmlError(
                f"d{st}/dt references unresolved symbols {sorted(map(str, extra))}"
                " (unassigned non-constant parameter or missing value?)")

    model = from_sympy(name=model_id, states=states, params=params,
                       odes=odes, y0=y0_exprs, t=t_sym)
    if any(v != v for v in param_vals):  # NaN check without numpy import
        bad = [pid for pid, v in zip(param_ids, param_vals) if v != v]
        raise SbmlError(f"parameters without values: {bad}")
    if events == "raise":
        return model, tuple(param_vals)

    # ---- events="lower": constant-time triggers -> timed-input records --
    state_ids = [str(s) for s in states]
    lowered = []
    for ev in event_nodes:
        eid = ev.get("id") or f"event{len(lowered)}"
        if _find(ev, "delay") is not None:
            raise SbmlUnsupportedError(f"event {eid!r}: delays")
        trig = _find(ev, "trigger")
        if trig is None:
            raise SbmlError(f"event {eid!r} without trigger")
        rel = mathml.parse_container(_find(trig, "math"))
        rel = rel.xreplace(assignments)
        # accept time >= c / time > c / c <= time / c < time with numeric c
        t_time = None
        if isinstance(rel, (sp.Ge, sp.Gt)) and rel.args[0] == t_sym:
            t_time = rel.args[1]
        elif isinstance(rel, (sp.Le, sp.Lt)) and rel.args[1] == t_sym:
            t_time = rel.args[0]
        if t_time is None or t_time.free_symbols:
            raise SbmlUnsupportedError(
                f"event {eid!r}: only constant-time triggers "
                "(time >= c) can be lowered; state-dependent triggers "
                "need the BDF solver's EventSpec root-finding")
        t_c = float(t_time)
        for ea in _list_of(ev, "listOfEventAssignments", "eventAssignment"):
            var = ea.get("variable")
            if var is None:
                raise SbmlError(f"event {eid!r}: assignment without "
                                "variable")
            val_expr = mathml.parse_container(
                _find(ea, "math")).xreplace(assignments)
            if val_expr.free_symbols:
                raise SbmlUnsupportedError(
                    f"event {eid!r}: assignment to {var!r} is not a "
                    "constant (state/parameter-dependent event "
                    "assignments cannot be lowered)")
            val = float(val_expr)
            if var in param_ids:
                lowered.append(("param", t_c, var, val))
            elif var in state_ids:
                lowered.append(("state", t_c, var, val))
            else:
                raise SbmlUnsupportedError(
                    f"event {eid!r}: assignment target {var!r} is "
                    "neither a model parameter nor a state")
    return model, tuple(param_vals), tuple(lowered)
