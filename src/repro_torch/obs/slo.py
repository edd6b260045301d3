"""Declarative SLO watchdog over registry snapshots (port of
``repro/obs/slo.py``; docs/observability.md).

A ``Rule`` names a metric pattern (fnmatch over the FLAT series names,
so one rule covers ``engine.anomalies`` and every
``engine.anomalies{replica=rN}``), how to read an observation out of a
snapshot (``kind``), a threshold predicate, and a multi-window
burn-rate condition: the rule fires for a series only when, for EVERY
window ``(n, frac)``, at least ``frac`` of the last ``n`` observations
breach the predicate AND the window is full.  The classic long+short
pairing means a sustained burn alerts while a single flapping snapshot
does not; a latch emits one alert per excursion (re-armed when the
breach clears) instead of one per snapshot.

Observation kinds:

* ``gauge`` / ``counter`` — the series' snapshot value.
* ``histogram`` — a field of the histogram dict (default ``p99``).
* ``rate`` — the counter's delta since the previous snapshot (first
  snapshot contributes no observation).
* ``ratio`` — this counter's delta over ``denom``'s delta, the
  denominator resolved with the SAME labels as the numerator series
  (falling back to the unlabelled denominator); windows with no
  denominator progress contribute no observation.

Alerts are JSONL records (``{"type": "alert", ...}`` — schema in
``obs/emit.py``); the ``Emitter`` evaluates the watchdog on every
snapshot it writes and appends the fired alerts right behind it.  When
bound to a registry, each fired alert also bumps a ``slo.alerts``
counter carrying the offending series' labels — that is the hook
``fleet/replica.py`` consumes: a replica-labelled alert degrades that
replica's health score.

CLI (CI-friendly exit codes)::

    python -m repro_torch.obs.slo METRICS.jsonl [--rules RULES.json]
                                          [--fail-on page|warn]

re-evaluates the rules over the file's snapshot sequence; exit 0 when
no alert at/above the failure severity fired, 1 when one did, 2 on
malformed input.

Left out: nothing of the watchdog.  Its ``slo.alerts`` counters are read
by ``stats()`` readers, the emitter and ``fleet/replica.py`` (a replica
folds their sum into its health).
"""
from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import json
import sys
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import flat_name

SEVERITIES = ("warn", "page")
OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}
ALERT_KEYS = ("type", "t_s", "rule", "severity", "series", "value",
              "threshold", "op")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative SLO rule (see the module docstring for kinds and
    burn-window semantics)."""
    name: str
    metric: str                      # fnmatch pattern over flat series names
    kind: str = "gauge"              # gauge | counter | histogram | rate | ratio
    field: str = "p99"               # histogram field to read
    op: str = ">"
    threshold: float = 0.0
    denom: Optional[str] = None      # ratio: denominator counter base name
    windows: Tuple[Tuple[int, float], ...] = ((1, 1.0),)
    severity: str = "page"

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"rule {self.name!r}: severity "
                             f"{self.severity!r} not in {SEVERITIES}")
        if self.kind not in ("gauge", "counter", "histogram", "rate",
                             "ratio"):
            raise ValueError(f"rule {self.name!r}: unknown kind "
                             f"{self.kind!r}")
        if self.kind == "ratio" and not self.denom:
            raise ValueError(f"rule {self.name!r}: ratio needs a denom")
        if not self.windows:
            raise ValueError(f"rule {self.name!r}: needs >=1 window")
        for n, frac in self.windows:
            if n < 1 or not (0.0 < frac <= 1.0):
                raise ValueError(f"rule {self.name!r}: bad window "
                                 f"({n}, {frac})")


def default_rules() -> Tuple[Rule, ...]:
    """The stock ruleset (docs/observability.md "SLO rules").  Thresholds
    are deliberately generous — they pass a healthy smoke serve and fire
    on the failure modes the chaos/CI gates inject (anomaly bursts,
    poisoned drift/agreement)."""
    return (
        # any NaN-guard trip between two snapshots is an instant page —
        # the window (1, 1.0) makes the anomaly rate rule the degenerate
        # "NaN guard" case of the burn framework
        Rule("anomaly-burst", metric="engine.anomalies*", kind="rate",
             op=">", threshold=0.0, windows=((1, 1.0),), severity="page"),
        # quality burn: online shadow-oracle drift/agreement (gauges only
        # exist when --shadow-sample is on; absent series never fire)
        Rule("logit-drift", metric="health.logit_drift*", kind="gauge",
             op=">", threshold=10.0, windows=((2, 1.0),), severity="page"),
        Rule("greedy-agreement", metric="health.greedy_agreement*",
             kind="gauge", op="<", threshold=0.5, windows=((2, 1.0),),
             severity="page"),
        # latency SLO: TTFT p99 sustained over 30s for 3 snapshots
        Rule("ttft-p99", metric="trace.ttft_s*", kind="histogram",
             field="p99", op=">", threshold=30.0, windows=((3, 1.0),),
             severity="page"),
        # goodput stall: no decoded tokens across a long+short window pair
        Rule("goodput-stall", metric="tokens", kind="rate", op="<=",
             threshold=0.0, windows=((8, 1.0), (4, 1.0)),
             severity="warn"),
        # KV write saturation: >50% of page-write values at the int8 rail
        Rule("kv-clip-rate", metric="quant.clip.kv_clipped*", kind="ratio",
             denom="quant.clip.kv_total", op=">", threshold=0.5,
             windows=((3, 1.0),), severity="warn"),
    )


def rules_from_json(path: str) -> Tuple[Rule, ...]:
    """Load rules from a JSON list of Rule-field dicts."""
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, list):
        raise ValueError(f"{path}: expected a JSON list of rule objects")
    rules = []
    for obj in raw:
        obj = dict(obj)
        if "windows" in obj:
            obj["windows"] = tuple((int(n), float(f))
                                   for n, f in obj["windows"])
        rules.append(Rule(**obj))
    return tuple(rules)


def _split_series(fname: str) -> Tuple[str, Dict[str, str]]:
    """Flat ``name{k=v,...}`` -> (base name, labels dict)."""
    if "{" not in fname:
        return fname, {}
    base, _, rest = fname.partition("{")
    labels = {}
    for pair in rest.rstrip("}").split(","):
        k, _, v = pair.partition("=")
        labels[k] = v
    return base, labels


class SloWatchdog:
    """Feed snapshots in emission order via ``observe``; fired alerts
    come back as JSONL-ready dicts (and accumulate on ``.alerts``)."""

    def __init__(self, rules: Optional[Sequence[Rule]] = None,
                 registry=None):
        self.rules: Tuple[Rule, ...] = (tuple(rules) if rules is not None
                                        else default_rules())
        self._registry = registry
        self._hist: Dict[Tuple[str, str], deque] = {}
        self._active: Dict[Tuple[str, str], bool] = {}
        self._prev_counters: Optional[Dict[str, float]] = None
        self.alerts: List[Dict] = []

    def bind(self, registry) -> None:
        """Attach the registry whose ``slo.alerts`` counters fired alerts
        bump (labels copied from the offending series)."""
        self._registry = registry

    # -- observation extraction -------------------------------------------
    def _observations(self, rule: Rule, snap: Dict) -> Dict[str, float]:
        """{series flat name: observation value} for one snapshot."""
        out: Dict[str, float] = {}
        counters = snap.get("counters", {})
        if rule.kind in ("gauge", "counter"):
            section = snap.get("gauges" if rule.kind == "gauge"
                               else "counters", {})
            for fname, v in section.items():
                if fnmatch.fnmatchcase(fname, rule.metric):
                    out[fname] = float(v)
        elif rule.kind == "histogram":
            for fname, h in snap.get("histograms", {}).items():
                if fnmatch.fnmatchcase(fname, rule.metric):
                    v = h.get(rule.field)
                    if v is not None:
                        out[fname] = float(v)
        elif rule.kind in ("rate", "ratio"):
            prev = self._prev_counters
            if prev is None:
                return out
            for fname, v in counters.items():
                if not fnmatch.fnmatchcase(fname, rule.metric):
                    continue
                if fname not in prev:
                    continue          # series born this window: no rate yet
                d = float(v) - float(prev[fname])
                if rule.kind == "rate":
                    out[fname] = d
                    continue
                _, labels = _split_series(fname)
                dname = flat_name(rule.denom,
                                  tuple(sorted(labels.items())))
                if dname not in counters:
                    dname = rule.denom
                if dname not in counters or dname not in prev:
                    continue
                dd = float(counters[dname]) - float(prev[dname])
                if dd > 0:
                    out[fname] = d / dd
        return out

    # -- evaluation --------------------------------------------------------
    def observe(self, snap: Dict) -> List[Dict]:
        """Evaluate every rule against one snapshot; returns the alerts
        fired BY this snapshot (also appended to ``self.alerts``)."""
        fired: List[Dict] = []
        maxwin = {r.name: max(n for n, _ in r.windows) for r in self.rules}
        for rule in self.rules:
            for series, value in self._observations(rule, snap).items():
                key = (rule.name, series)
                hist = self._hist.get(key)
                if hist is None:
                    hist = self._hist[key] = deque(maxlen=maxwin[rule.name])
                hist.append(OPS[rule.op](value, rule.threshold))
                burning = all(
                    len(hist) >= n
                    and sum(list(hist)[-n:]) >= frac * n
                    for n, frac in rule.windows)
                if burning and not self._active.get(key, False):
                    alert = {
                        "type": "alert",
                        "t_s": snap.get("t_s", 0.0),
                        "seq": snap.get("seq"),
                        "rule": rule.name,
                        "severity": rule.severity,
                        "series": series,
                        "value": value,
                        "threshold": rule.threshold,
                        "op": rule.op,
                        "windows": [list(w) for w in rule.windows],
                    }
                    fired.append(alert)
                    self.alerts.append(alert)
                    if self._registry is not None:
                        _, labels = _split_series(series)
                        self._registry.counter("slo.alerts",
                                               **labels).inc()
                self._active[key] = burning
        self._prev_counters = dict(snap.get("counters", {}))
        return fired

    def stats(self) -> Dict:
        by_rule: Dict[str, int] = {}
        for a in self.alerts:
            by_rule[a["rule"]] = by_rule.get(a["rule"], 0) + 1
        return {"alerts": len(self.alerts),
                "page_alerts": sum(1 for a in self.alerts
                                   if a["severity"] == "page"),
                "by_rule": by_rule}


def evaluate_file(path: str,
                  rules: Optional[Sequence[Rule]] = None) -> Dict:
    """Re-evaluate rules over an emitter JSONL file's snapshot sequence.
    Returns {"watchdog": SloWatchdog, "snapshots": n, "embedded_alerts":
    n} — embedded alerts are ``alert`` lines already present in the file
    (written by a live watchdog during the run)."""
    wd = SloWatchdog(rules)
    snapshots = 0
    embedded = 0
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
            if obj.get("type") == "snapshot":
                snapshots += 1
                wd.observe(obj)
            elif obj.get("type") == "alert":
                embedded += 1
    if not snapshots:
        raise ValueError(f"{path}: no snapshot lines")
    return {"watchdog": wd, "snapshots": snapshots,
            "embedded_alerts": embedded}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Evaluate SLO rules over an obs emitter JSONL file "
                    "(docs/observability.md 'Numerics & quality health').")
    ap.add_argument("metrics", metavar="METRICS.jsonl",
                    help="emitter JSONL file (snapshot lines)")
    ap.add_argument("--rules", metavar="RULES.json", default=None,
                    help="JSON list of Rule dicts (default: stock rules)")
    ap.add_argument("--fail-on", choices=SEVERITIES, default="page",
                    help="minimum severity that makes the exit code "
                         "nonzero (default: page)")
    args = ap.parse_args(argv)
    try:
        rules = rules_from_json(args.rules) if args.rules else None
        rep = evaluate_file(args.metrics, rules)
    except (OSError, ValueError) as e:
        print(f"[obs.slo] error: {e}", file=sys.stderr)
        return 2
    wd = rep["watchdog"]
    st = wd.stats()
    fail_severities = (SEVERITIES if args.fail_on == "warn"
                       else ("page",))
    failing = [a for a in wd.alerts if a["severity"] in fail_severities]
    print(f"[obs.slo] {args.metrics}: {rep['snapshots']} snapshots, "
          f"{len(wd.rules)} rules, {st['alerts']} alerts fired "
          f"({st['page_alerts']} page), "
          f"{rep['embedded_alerts']} embedded alert lines")
    for a in wd.alerts:
        print(f"[obs.slo]   {a['severity'].upper()} {a['rule']} "
              f"{a['series']}: {a['value']:.6g} {a['op']} "
              f"{a['threshold']:.6g} (seq {a['seq']})")
    if failing:
        print(f"[obs.slo] FAIL: {len(failing)} alert(s) at/above "
              f"--fail-on={args.fail_on}", file=sys.stderr)
        return 1
    print("[obs.slo] OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
