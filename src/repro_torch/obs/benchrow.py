"""Schema'd performance-trajectory rows, ``BENCH_<name>.json``
(counterpart of ``repro/obs/benchrow.py``; a row either package writes
loads in the other).

One file per bench config holds an append-only trajectory of runs:

    {"schema": 1, "name": "serve_smoke", "rows": [ {row}, {row}, ... ]}

Each row is one run's scalars (step time, tokens/s per device, serve
latency percentiles: what the producer measured) and enough context to
read them (kind, devices).  ``compare`` diffs the newest row against the
median of the previous rows (one noisy run must not move the baseline),
with each metric's direction and tolerance from ``GATED_METRICS``; the
tolerances catch 2x cliffs, not 3% wobble.  Model-drift metrics are
recorded and never gated.
"""
from __future__ import annotations

import json
import math
import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SCHEMA_VERSION = 1
KINDS = ("train", "serve")
_NAME_RE = re.compile(r"^[A-Za-z0-9_.-]+$")

# metric -> (direction, relative tolerance). direction "lower" = smaller
# is better.  Only these participate in the regression gate; every other
# metric in a row is trajectory data.
GATED_METRICS: Dict[str, Tuple[str, float]] = {
    "mean_step_s": ("lower", 0.35),
    "tokens_per_s_device": ("higher", 0.35),
    "latency_p50_s": ("lower", 0.40),
    "latency_p99_s": ("lower", 0.60),       # tail is the noisiest
}


def bench_file(out_dir: str, name: str) -> str:
    return os.path.join(out_dir, f"BENCH_{name}.json")


def bench_row(*, name: str, kind: str, metrics: Dict[str, float],
              context: Optional[Dict] = None,
              ts: Optional[float] = None) -> Dict:
    """Build + validate one trajectory row."""
    row = {
        "name": name,
        "kind": kind,
        "ts": float(time.time() if ts is None else ts),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "context": dict(context or {}),
    }
    validate_row(row, name=name)
    return row


def validate_row(row: Dict, *, name: Optional[str] = None) -> None:
    """Raise ValueError unless ``row`` is a schema-valid trajectory row."""
    if not isinstance(row, dict):
        raise ValueError(f"bench row must be a dict, got {type(row)}")
    rname = row.get("name")
    if not isinstance(rname, str) or not _NAME_RE.match(rname):
        raise ValueError(f"bench row name {rname!r} is not a valid "
                         f"[A-Za-z0-9_.-]+ identifier")
    if name is not None and rname != name:
        raise ValueError(f"bench row name {rname!r} != file name {name!r}")
    if row.get("kind") not in KINDS:
        raise ValueError(f"bench row kind {row.get('kind')!r} not in "
                         f"{KINDS}")
    metrics = row.get("metrics")
    if not isinstance(metrics, dict) or not metrics:
        raise ValueError("bench row has no metrics dict")
    for k, v in metrics.items():
        if not isinstance(v, (int, float)) or not math.isfinite(float(v)):
            raise ValueError(f"bench metric {k}={v!r} is not a finite "
                             f"number")
    if not isinstance(row.get("ts"), (int, float)):
        raise ValueError("bench row has no numeric ts")
    if not isinstance(row.get("context", {}), dict):
        raise ValueError("bench row context must be a dict")


def append_row(out_dir: str, row: Dict, *, max_rows: int = 200) -> str:
    """Append ``row`` to ``BENCH_<row.name>.json`` (atomic tmp+replace;
    the trajectory is bounded to the last ``max_rows``).  Returns the
    file path."""
    validate_row(row)
    os.makedirs(out_dir, exist_ok=True)
    path = bench_file(out_dir, row["name"])
    doc = {"schema": SCHEMA_VERSION, "name": row["name"], "rows": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f)
            if isinstance(prev, dict) \
                    and prev.get("schema") == SCHEMA_VERSION \
                    and prev.get("name") == row["name"]:
                doc["rows"] = [r for r in prev.get("rows", [])
                               if isinstance(r, dict)]
        except (OSError, json.JSONDecodeError):
            pass                        # corrupt history: restart it
    doc["rows"] = (doc["rows"] + [row])[-max_rows:]
    fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=".tmp-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_rows(path: str) -> List[Dict]:
    """Validated rows of one ``BENCH_*.json`` file (invalid rows are
    dropped, not raised — the gate compares what it can)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"{path}: not a schema-{SCHEMA_VERSION} bench "
                         f"file")
    out = []
    for r in doc.get("rows", []):
        try:
            validate_row(r, name=doc.get("name"))
        except ValueError:
            continue
        out.append(r)
    return out


@dataclass(frozen=True)
class MetricDelta:
    metric: str
    latest: float
    baseline: float                 # median of the previous rows
    direction: str                  # "lower" | "higher" is better
    tolerance: float

    @property
    def rel_change(self) -> float:
        """Signed relative change, positive = worse (direction-aware)."""
        denom = max(abs(self.baseline), 1e-12)
        raw = (self.latest - self.baseline) / denom
        return raw if self.direction == "lower" else -raw

    @property
    def regressed(self) -> bool:
        return self.rel_change > self.tolerance


@dataclass(frozen=True)
class Comparison:
    name: str
    n_baseline: int                 # rows the baseline median came from
    deltas: Tuple[MetricDelta, ...] = field(default_factory=tuple)

    @property
    def regressions(self) -> Tuple[MetricDelta, ...]:
        return tuple(d for d in self.deltas if d.regressed)

    @property
    def ok(self) -> bool:
        return not self.regressions

    def describe(self) -> str:
        if self.n_baseline == 0:
            return (f"{self.name}: first recorded run — no baseline, "
                    f"nothing to gate")
        lines = [f"{self.name}: latest vs median of {self.n_baseline} "
                 f"previous run(s)"]
        for d in self.deltas:
            mark = "REGRESSED" if d.regressed else "ok"
            lines.append(
                f"  {d.metric}: {d.latest:.4g} vs {d.baseline:.4g} "
                f"({d.rel_change:+.1%} worse-direction, "
                f"tol {d.tolerance:.0%}) {mark}")
        return "\n".join(lines)


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def compare(rows: List[Dict], *,
            gated: Optional[Dict[str, Tuple[str, float]]] = None
            ) -> Comparison:
    """Latest row vs the median of all previous rows, over the gated
    metrics both sides carry."""
    gated = GATED_METRICS if gated is None else gated
    if not rows:
        return Comparison(name="<empty>", n_baseline=0)
    latest = rows[-1]
    history = rows[:-1]
    deltas = []
    for metric, (direction, tol) in sorted(gated.items()):
        if metric not in latest.get("metrics", {}):
            continue
        base_vals = [float(r["metrics"][metric]) for r in history
                     if metric in r.get("metrics", {})]
        if not base_vals:
            continue
        deltas.append(MetricDelta(
            metric=metric, latest=float(latest["metrics"][metric]),
            baseline=_median(base_vals), direction=direction,
            tolerance=float(tol)))
    return Comparison(name=str(latest.get("name")),
                      n_baseline=len(history), deltas=tuple(deltas))
