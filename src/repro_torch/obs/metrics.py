"""In-graph metrics: a fixed schema of f32 scalar counters and gauges
(counterpart of ``repro/obs/metrics.py``).

``MetricBag`` rides the MoE layer's stats from core/moe.py through the
blocks of models/model.py (``merge_stat``) into the step's metrics
(``as_metrics``: the ``obs_*`` scalars).  Its values are 0-d f32 tensors
computed without gradient, so they feed nothing the loss reads.  A
``counter`` adds under ``merge`` (wire bytes summed over the MoE layers),
a ``gauge`` takes the newer value (the last layer's, as in JAX).

  wire_bytes / raw_bytes     counter  bytes that crossed (or would have
                                      crossed) the all-to-all this step,
                                      both legs, every MoE layer; their
                                      ratio is the live Eq. 5 rate
  load_imbalance             gauge    max / mean of the routed-token
                                      counts per real expert, all ranks
  drop_fraction              gauge    (token, choice) entries dropped to
                                      the capacity overflow bin
  slot_occupancy             gauge    occupied share of the LSH slots
                                      (0 with LSH off)
  comm_algorithm/_degraded/
  _calibrated/_wire_format   gauge    the resolved comm plan, as floats
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

COUNTER = "counter"
GAUGE = "gauge"
KINDS = (COUNTER, GAUGE)

MOE_SCHEMA: Tuple[Tuple[str, str], ...] = (
    ("wire_bytes", COUNTER),
    ("raw_bytes", COUNTER),
    ("load_imbalance", GAUGE),
    ("drop_fraction", GAUGE),
    ("slot_occupancy", GAUGE),
    ("comm_algorithm", GAUGE),
    ("comm_degraded", GAUGE),
    ("comm_calibrated", GAUGE),
    ("comm_wire_format", GAUGE),
)


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32,
                           device=device).detach().reshape(())


class MetricBag:
    """An immutable bag of named 0-d f32 tensors; every mutator returns a
    new bag."""

    __slots__ = ("_schema", "_values")

    def __init__(self, schema: Iterable[Tuple[str, str]], values):
        self._schema = tuple((str(n), str(k)) for n, k in schema)
        self._values = tuple(values)
        if len(self._schema) != len(self._values):
            raise ValueError(
                f"schema has {len(self._schema)} entries, got "
                f"{len(self._values)} values")

    @classmethod
    def zeros(cls, schema: Iterable[Tuple[str, str]] = MOE_SCHEMA, *,
              device=None) -> "MetricBag":
        schema = tuple(schema)
        for name, kind in schema:
            if kind not in KINDS:
                raise ValueError(f"metric {name!r}: unknown kind {kind!r}")
        return cls(schema, tuple(torch.zeros((), dtype=torch.float32,
                                             device=device)
                                 for _ in schema))

    @property
    def schema(self) -> Tuple[Tuple[str, str], ...]:
        return self._schema

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self._schema)

    def kind(self, name: str) -> str:
        return self._schema[self._index(name)][1]

    def _index(self, name: str) -> int:
        for i, (n, _) in enumerate(self._schema):
            if n == name:
                return i
        raise KeyError(f"metric {name!r} not in schema {list(self.names)}")

    def get(self, name: str) -> torch.Tensor:
        return self._values[self._index(name)]

    def set(self, name: str, value) -> "MetricBag":
        """Overwrite ``name`` (counter or gauge) with ``value`` (f32)."""
        i = self._index(name)
        vals = list(self._values)
        vals[i] = _f32(value, vals[i].device)
        return MetricBag(self._schema, vals)

    def inc(self, name: str, delta) -> "MetricBag":
        """Add ``delta`` to counter ``name``; a gauge raises."""
        i = self._index(name)
        if self._schema[i][1] != COUNTER:
            raise ValueError(f"metric {name!r} is a {self._schema[i][1]}, "
                             f"not a counter: use .set()")
        vals = list(self._values)
        vals[i] = vals[i] + _f32(delta, vals[i].device)
        return MetricBag(self._schema, vals)

    def merge(self, other: "MetricBag") -> "MetricBag":
        """Fold ``other``, the newer observation, in: counters add, gauges
        take ``other``'s value."""
        if other._schema != self._schema:
            raise ValueError(f"schema mismatch: {self._schema} vs "
                             f"{other._schema}")
        return MetricBag(self._schema, [
            a + b if kind == COUNTER else b
            for (_, kind), a, b in zip(self._schema, self._values,
                                       other._values)])

    def as_metrics(self, prefix: str = "obs_") -> Dict[str, torch.Tensor]:
        """The bag as step metrics: {prefix + name: 0-d f32 tensor}."""
        return {prefix + name: v
                for (name, _), v in zip(self._schema, self._values)}


def merge_stat(old, new):
    """Carry update of a layer's stat across the blocks: a bag merges into
    the bag before it; anything else overwrites."""
    if isinstance(new, MetricBag) and isinstance(old, MetricBag):
        return old.merge(new)
    return new


def is_bag(x) -> bool:
    return isinstance(x, MetricBag)
