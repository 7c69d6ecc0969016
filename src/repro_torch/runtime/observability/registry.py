"""Unified metrics registry: labeled counters/gauges/histograms + pull
collectors, one ``snapshot()``/text-exposition surface (DESIGN.md §13).

Two kinds of metric feed the registry:

  * **Native instruments** — ``counter``/``gauge``/``histogram`` handles
    created here and mutated on the hot path (e.g. the request-latency
    histogram fed on every trace finish).  Mutations are a dict update
    under one registry lock — cheap enough to stay always-on.
  * **Collectors** — pull callbacks sampled at ``snapshot()`` time that
    map the stack's existing per-tier state (``ServiceStats``, broker
    queue depths and counters, registry hit/evict, prethinner
    speculation, controller EMAs, deadline-miss accounting) into the one
    stable namespace.  The sources keep their plain ints/dicts — the
    registry absorbs them at scrape time instead of rewriting five tiers'
    bookkeeping onto shared instrument objects.

The layout is schema-tested: every metric name the stack can emit is
enumerated in ``repro_torch.runtime.observability.SCHEMA``; the snapshot's names
must be a subset of it and its label keys must match the schema's —
``tests/test_observability.py`` pins both, so a rename or an accidental
new surface breaks CI instead of silently forking dashboards.

Exposition follows the Prometheus text conventions (``# TYPE`` header,
``name{label="v"} value`` samples, ``_bucket``/``_sum``/``_count``
expansion for histograms) so the surface scrapes without an adapter.
"""

from __future__ import annotations

import threading
from bisect import bisect_left

_TYPES = ("counter", "gauge", "histogram")

DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0)


def _label_key(labelnames: tuple, labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[k]) for k in labelnames)


class _Child:
    """One (metric, label-values) series."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "_Metric", key: tuple):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        if self._metric.mtype not in ("counter", "gauge"):
            raise TypeError(f"inc() on a {self._metric.mtype}")
        if self._metric.mtype == "counter" and amount < 0:
            raise ValueError("counters only go up")
        with self._metric._lock:
            self._metric._values[self._key] = \
                self._metric._values.get(self._key, 0.0) + amount

    def set(self, value: float) -> None:
        if self._metric.mtype != "gauge":
            raise TypeError(f"set() on a {self._metric.mtype}")
        with self._metric._lock:
            self._metric._values[self._key] = float(value)

    def observe(self, value: float) -> None:
        if self._metric.mtype != "histogram":
            raise TypeError(f"observe() on a {self._metric.mtype}")
        v = float(value)
        with self._metric._lock:
            h = self._metric._values.get(self._key)
            if h is None:
                # One slot per bucket plus the +Inf overflow; stored
                # per-bucket (one bisect + one increment on the hot path)
                # and converted to Prometheus-cumulative at snapshot time.
                h = self._metric._values[self._key] = {
                    "count": 0, "sum": 0.0,
                    "buckets": [0] * (len(self._metric.buckets) + 1)}
            h["count"] += 1
            h["sum"] += v
            h["buckets"][bisect_left(self._metric.buckets, v)] += 1


class _Metric:
    def __init__(self, name: str, mtype: str, help: str = "",
                 labelnames: tuple = (), buckets: tuple = DEFAULT_BUCKETS):
        if mtype not in _TYPES:
            raise ValueError(f"unknown metric type {mtype!r}")
        self.name = name
        self.mtype = mtype
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets))
        self._values: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def labels(self, **labels) -> _Child:
        return _Child(self, _label_key(self.labelnames, labels))

    # Unlabeled convenience: metric acts as its own single child.
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def _snapshot_values(self) -> dict:
        with self._lock:
            out = {}
            for key, v in self._values.items():
                if isinstance(v, dict):
                    cum, buckets = 0, {}
                    for le, n in zip(self.buckets, v["buckets"]):
                        cum += n
                        buckets[le] = cum
                    v = {"count": v["count"], "sum": v["sum"],
                         "buckets": buckets}
                out[key] = v
            return out


class MetricsRegistry:
    """Namespace of metrics + pull collectors (module docstring)."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # Native instruments
    # ------------------------------------------------------------------

    def _make(self, name, mtype, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.mtype != mtype or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-declared with a different "
                        f"type/labels")
                return m
            m = self._metrics[name] = _Metric(name, mtype, help,
                                              labelnames, **kw)
            return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> _Metric:
        return self._make(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> _Metric:
        return self._make(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets: tuple = DEFAULT_BUCKETS) -> _Metric:
        return self._make(name, "histogram", help, labelnames,
                          buckets=buckets)

    # ------------------------------------------------------------------
    # Collectors
    # ------------------------------------------------------------------

    def register_collector(self, fn) -> None:
        """``fn() -> iterable of sample dicts`` pulled at snapshot time.
        Each sample: ``{"name", "type", "value", "labels"?, "help"?}``."""
        self._collectors.append(fn)

    def _collect(self) -> list[dict]:
        samples = []
        for fn in self._collectors:
            samples.extend(fn())
        return samples

    # ------------------------------------------------------------------
    # Surfaces
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """Stable nested layout::

            {name: {"type": ..., "labelnames": [...],
                    "values": {(label values tuple as "a|b" str): value}}}

        Histogram values are ``{"count", "sum", "buckets": {le: n}}``.
        Collector samples merge into the same namespace; a name collision
        between a native metric and a collector raises loudly.
        """
        with self._lock:
            native = dict(self._metrics)
        out: dict[str, dict] = {}
        for name in sorted(native):
            m = native[name]
            out[name] = {
                "type": m.mtype, "help": m.help,
                "labelnames": list(m.labelnames),
                "values": {"|".join(k): v
                           for k, v in m._snapshot_values().items()},
            }
        for s in self._collect():
            name = s["name"]
            if name in native:
                raise ValueError(
                    f"collector sample {name!r} collides with a native "
                    f"metric")
            labels = s.get("labels", {})
            entry = out.setdefault(name, {
                "type": s.get("type", "gauge"), "help": s.get("help", ""),
                "labelnames": sorted(labels), "values": {}})
            key = "|".join(str(labels[k]) for k in entry["labelnames"])
            entry["values"][key] = s["value"]
        return dict(sorted(out.items()))

    def schema(self) -> dict:
        """``{name: (type, sorted label keys)}`` for the current snapshot
        — the shape the schema test pins against ``SCHEMA``."""
        return {name: (e["type"], tuple(e["labelnames"]))
                for name, e in self.snapshot().items()}

    def exposition(self) -> str:
        """Prometheus text exposition of the full snapshot."""
        lines = []
        for name, entry in self.snapshot().items():
            lines.append(f"# TYPE {name} {entry['type']}")
            labelnames = entry["labelnames"]
            for key, v in sorted(entry["values"].items()):
                values = key.split("|") if key else []
                pairs = ",".join(f'{k}="{val}"'
                                 for k, val in zip(labelnames, values))
                if isinstance(v, dict):   # histogram expansion
                    # Snapshot buckets are already cumulative.
                    for le, n in sorted(v["buckets"].items()):
                        blabels = (pairs + "," if pairs else "") + \
                            f'le="{le}"'
                        lines.append(f"{name}_bucket{{{blabels}}} {n}")
                    inf = (pairs + "," if pairs else "") + 'le="+Inf"'
                    lines.append(f"{name}_bucket{{{inf}}} {v['count']}")
                    suffix = f"{{{pairs}}}" if pairs else ""
                    lines.append(f"{name}_sum{suffix} {v['sum']:.6g}")
                    lines.append(f"{name}_count{suffix} {v['count']}")
                else:
                    suffix = f"{{{pairs}}}" if pairs else ""
                    lines.append(f"{name}{suffix} {v:.6g}"
                                 if isinstance(v, float)
                                 else f"{name}{suffix} {v}")
        return "\n".join(lines) + "\n"
