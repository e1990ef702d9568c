"""Strict v2 wire schema of the serving front end.

This is the *over-the-wire* contract of :mod:`repro_torch.serve.server`
— deliberately a separate, stricter parser than the request-**file**
loader (:func:`repro_torch.serve.cli.load_requests`):

* the file loader stays lenient for operators (``"v"`` defaults to 1,
  v1 auto-upgrades, stray fields are the operator's own file);
* the wire rejects anything it does not fully understand, loudly —
  a remote client's typo (``"evidnce"``) silently dropping evidence
  would serve a *wrong posterior* with a 200 status.  So: ``"v": 2``
  is required (v1 and missing-``v`` are errors with an upgrade hint),
  unknown fields are errors naming the offender and the accepted set,
  and every field is type-checked before a query object is built.

Bitwise identity over JSON: marginals are float64 numpy values (the
engine's ``Result.marginals`` are host arrays, never device tensors);
Python's ``json`` emits the shortest round-tripping decimal for a float,
so a served marginal parsed back with ``float()`` is *bit-identical* to
the in-process value — the served-vs-in-process identity checks
(``--connect --identity-check``, ``chip_smoke.py``'s wire phase) lean on
this.

Functions raise :class:`WireError`, which carries the HTTP status code
and a JSON-able error body; nothing here imports torch, so a client
process can encode and decode without one.

>>> q, rid = parse_wire_request({"v": 2, "network": "asia",
...     "evidence": {"smoke": 1}, "query_vars": ["lung"], "id": 7})
>>> q.network, q.evidence, rid
('asia', {'smoke': 1}, 7)
>>> parse_wire_request({"v": 1, "network": "asia"})
Traceback (most recent call last):
  ...
repro_torch.serve.protocol.WireError: schema v1 is not accepted over the \
wire: set "v": 2 (the request-file loader still auto-upgrades v1 files)
>>> parse_wire_request({"v": 2, "network": "asia", "evidnce": {}})
... # doctest: +ELLIPSIS
Traceback (most recent call last):
  ...
repro_torch.serve.protocol.WireError: unknown field(s) 'evidnce' ...
"""
from __future__ import annotations

import numpy as np

from repro_torch.serve.query import (
    MODES, IsingQuery, MrfQuery, Query, Request, Result)

WIRE_VERSION = 2

# fields every family accepts; "id" is an opaque client correlation tag
# echoed in the response (required on WebSocket streams, where responses
# arrive in completion order, not submission order)
COMMON_FIELDS = frozenset({
    "v", "id", "network", "n_samples", "rhat_target", "ess_target",
    "mode", "stream_id", "deadline_ms", "tenant"})
BN_FIELDS = frozenset({"evidence", "query_vars"})
MRF_FIELDS = frozenset({"mask_sites", "query_sites"})
ISING_FIELDS = frozenset({"clamp_sites", "query_vars"})
ALL_FIELDS = COMMON_FIELDS | BN_FIELDS | MRF_FIELDS | ISING_FIELDS

# response fields that legitimately differ between two runs of the same
# query (wall clock, group co-tenancy) — conformance tests and the
# identity checks compare everything else
NONDETERMINISTIC_FIELDS = ("wall_s", "bits_per_sample", "n_sweeps",
                           "n_samples", "n_node_samples", "diagnostics",
                           "rhat", "cache_hit", "warm_start")

__all__ = [
    "WIRE_VERSION", "WireError", "parse_wire_request", "request_to_wire",
    "result_to_wire", "wire_marginals", "error_body",
    "NONDETERMINISTIC_FIELDS"]


class WireError(ValueError):
    """A request the wire schema refuses; carries the HTTP status and a
    JSON-able error body (``{"error": ..., "v": 2}``)."""

    def __init__(self, message: str, *, code: int = 400, **extra):
        super().__init__(message)
        self.code = int(code)
        self.body = {"error": message, "v": WIRE_VERSION, **extra}


def _require(cond: bool, message: str, **extra) -> None:
    if not cond:
        raise WireError(message, **extra)


def _as_int(obj: dict, field: str, default=None):
    v = obj.get(field, default)
    if v is None or v is default and field not in obj:
        return default
    _require(isinstance(v, int) and not isinstance(v, bool),
             f"field {field!r} must be an integer, got {v!r}")
    return v


def _as_num(obj: dict, field: str):
    v = obj.get(field)
    if v is None:
        return None
    _require(isinstance(v, (int, float)) and not isinstance(v, bool),
             f"field {field!r} must be a number, got {v!r}")
    return float(v)


def _as_str(obj: dict, field: str):
    v = obj.get(field)
    if v is None:
        return None
    _require(isinstance(v, str), f"field {field!r} must be a string, "
             f"got {v!r}")
    return v


def _pairs(obj: dict, field: str, arity: int):
    v = obj.get(field, [])
    _require(isinstance(v, (list, tuple)),
             f"field {field!r} must be a list of {arity}-item lists")
    out = []
    for t in v:
        _require(isinstance(t, (list, tuple)) and len(t) == arity
                 and all(isinstance(x, int) and not isinstance(x, bool)
                         for x in t),
                 f"field {field!r} must be a list of {arity}-item "
                 f"integer lists, got element {t!r}")
        out.append(tuple(t))
    return tuple(out)


def parse_wire_request(obj) -> tuple[Request, object]:
    """One wire object -> ``(query, request_id)``.  Strict: see the
    module docstring for what is rejected and why."""
    _require(isinstance(obj, dict),
             f"request must be a JSON object, got {type(obj).__name__}")
    if "v" not in obj:
        raise WireError(
            'missing required field "v": the wire accepts schema v2 '
            'only (set "v": 2)')
    if obj["v"] != WIRE_VERSION:
        raise WireError(
            f'schema v{obj["v"]} is not accepted over the wire: set '
            '"v": 2 (the request-file loader still auto-upgrades v1 '
            'files)')
    unknown = sorted(set(obj) - ALL_FIELDS)
    if unknown:
        raise WireError(
            f"unknown field(s) {', '.join(repr(f) for f in unknown)} "
            f"(accepted: {', '.join(sorted(ALL_FIELDS))})")
    network = obj.get("network")
    _require(isinstance(network, str) and network,
             'field "network" is required and must be a non-empty string')
    mode = obj.get("mode", "marginals")
    _require(mode in MODES,
             f"unknown inference mode {mode!r} "
             f"(accepted: {', '.join(MODES)})")
    common = dict(
        n_samples=_as_int(obj, "n_samples", 8192),
        rhat_target=_as_num(obj, "rhat_target"),
        ess_target=_as_num(obj, "ess_target"),
        mode=mode,
        stream_id=_as_str(obj, "stream_id"),
        deadline_ms=_as_num(obj, "deadline_ms"),
        tenant=_as_str(obj, "tenant"))

    is_mrf = "mask_sites" in obj or "query_sites" in obj
    is_ising = "clamp_sites" in obj
    _require(not (is_mrf and is_ising),
             "request mixes MRF fields (mask_sites/query_sites) with "
             "Ising fields (clamp_sites) — pick one family")
    _require(not ((is_mrf or is_ising) and "evidence" in obj),
             'field "evidence" is the Bayesian-network form; MRF uses '
             '"mask_sites", Ising uses "clamp_sites"')
    try:
        if is_mrf:
            _require("query_vars" not in obj,
                     'MRF requests report sites: use "query_sites", '
                     'not "query_vars"')
            query: Request = MrfQuery(
                network, mask_sites=_pairs(obj, "mask_sites", 3),
                query_sites=_pairs(obj, "query_sites", 2), **common)
        elif is_ising:
            query = IsingQuery(
                network, clamp_sites=_pairs(obj, "clamp_sites", 2),
                query_vars=_qvars(obj), **common)
        else:
            ev = obj.get("evidence", {})
            _require(isinstance(ev, dict) and all(
                isinstance(k, (str, int)) and not isinstance(k, bool)
                and isinstance(v, int) and not isinstance(v, bool)
                for k, v in ev.items()),
                'field "evidence" must map node names to integer values')
            query = Query(network, {_node_key(k): v for k, v in ev.items()},
                          _qvars(obj), **common)
    except WireError:
        raise
    except ValueError as exc:  # Request.__post_init__ validation
        raise WireError(str(exc)) from None
    return query, obj.get("id")


def _node_key(k):
    """JSON object keys are always strings, but the in-process API also
    accepts integer node *indices* as evidence keys — so an all-digit
    key decodes back to the index it was before ``json.dumps`` turned
    ``{4: 1}`` into ``{"4": 1}``.  (Named nodes are never all-digit.)

    >>> q, _ = parse_wire_request({"v": 2, "network": "asia",
    ...     "evidence": {"4": 1, "smoke": 0}})
    >>> sorted(q.evidence.items(), key=str)
    [('smoke', 0), (4, 1)]
    """
    return int(k) if isinstance(k, str) and k.isdigit() else k


def _qvars(obj: dict):
    v = obj.get("query_vars", [])
    _require(isinstance(v, (list, tuple)) and all(
        isinstance(x, (str, int)) and not isinstance(x, bool) for x in v),
        'field "query_vars" must be a list of node names or ids')
    return tuple(v)


def request_to_wire(query: Request, *, id=None) -> dict:
    """Inverse of :func:`parse_wire_request` — the client-side encoder.

    >>> q = Query("asia", {"smoke": 1}, ("lung",), n_samples=512)
    >>> w = request_to_wire(q)
    >>> parse_wire_request(w)[0] == q
    True
    """
    out: dict = {"v": WIRE_VERSION, "network": query.network,
                 "n_samples": query.n_samples}
    if id is not None:
        out["id"] = id
    for f in ("rhat_target", "ess_target", "stream_id", "deadline_ms",
              "tenant"):
        v = getattr(query, f)
        if v is not None:
            out[f] = v
    if query.mode != "marginals":
        out["mode"] = query.mode
    if isinstance(query, MrfQuery):
        out["mask_sites"] = [list(t) for t in query.mask_sites]
        if query.query_sites:
            out["query_sites"] = [list(t) for t in query.query_sites]
    elif isinstance(query, IsingQuery):
        out["clamp_sites"] = [list(t) for t in query.clamp_sites]
        if query.query_vars:
            out["query_vars"] = list(query.query_vars)
    else:
        out["evidence"] = dict(query.evidence)
        if query.query_vars:
            out["query_vars"] = list(query.query_vars)
    return out


def result_to_wire(result: Result, *, id=None) -> dict:
    """One :class:`repro_torch.serve.query.Result` as a JSON-able response
    object.  Marginals go out as float lists — bit-exact through JSON
    (shortest-round-trip float encoding)."""
    d = result.diagnostics
    out = {
        "v": WIRE_VERSION,
        "network": result.query.network,
        "mode": getattr(result.query, "mode", "marginals"),
        "marginals": ({name: np.asarray(m, np.float64).tolist()
                       for name, m in result.marginals.items()}
                      if result.map_assignment is None else None),
        "map_assignment": result.map_assignment,
        "map_energy": result.map_energy,
        "n_samples": result.n_samples,
        "n_sweeps": result.n_sweeps,
        "n_node_samples": result.n_node_samples,
        "rhat": float(result.rhat),
        "converged": bool(result.converged),
        "cache_hit": bool(result.cache_hit),
        "warm_start": bool(result.warm_start),
        "wall_s": float(result.wall_s),
        "bits_per_sample": float(result.bits_per_sample),
        "diagnostics": None if d is None else {
            "rhat": float(d.rhat), "rank_rhat": float(d.rank_rhat),
            "folded_rhat": float(d.folded_rhat),
            "ess_bulk": float(d.ess_bulk), "ess_tail": float(d.ess_tail),
            "sweeps_used": int(d.sweeps_used)},
    }
    if id is not None:
        out["id"] = id
    return out


def wire_marginals(response: dict) -> dict[str, np.ndarray]:
    """A wire response's marginals back as float64 arrays — bit-exact
    vs the serving process (see module docstring)."""
    m = response.get("marginals")
    if m is None:
        raise WireError("response carries no marginals (mode="
                        f"{response.get('mode')!r})")
    return {name: np.asarray(v, np.float64) for name, v in m.items()}


def error_body(exc: BaseException) -> dict:
    """JSON error body for any exception (WireError keeps its own)."""
    if isinstance(exc, WireError):
        return exc.body
    return {"error": f"{type(exc).__name__}: {exc}", "v": WIRE_VERSION}
