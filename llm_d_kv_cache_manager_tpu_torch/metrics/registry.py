"""A small Prometheus registry on the standard library.

The port's collectors (`metrics/collector.py`) register here, not in
`prometheus_client`: the package stands on the standard library wherever
the library is not on the card's installation, and one process that
imports both this package and the reference package would otherwise see
two registrations of every `kvcache_*` name in `prometheus_client`'s
default registry ("Duplicated timeseries").

What is kept of `prometheus_client` is what the collectors and their
readers use:

- `Counter`, `Gauge` and `Histogram`, with `labels()`, `inc`, `dec`, `set`,
  `observe` and `._value.get()` on an unlabelled collector or a child;
- `describe()` (the family without samples) and `collect()` on a collector,
  and `collect()` on a registry, yielding `Metric` families
  (`name`, `documentation`, `type`, `samples`), each sample a
  `Sample(name, labels, value)`; a counter's family name drops `_total`;
- a module-level `REGISTRY` and `generate_latest(registry)`, which writes
  the text exposition format 0.0.4 byte for byte as `prometheus_client`
  does, without the `_created` series.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

INF = float("inf")

class Sample(NamedTuple):
    name: str
    labels: Dict[str, str]
    value: float
    timestamp: Optional[float] = None
    exemplar: Optional[object] = None


class Metric:
    """One metric family as `collect()` yields it."""

    def __init__(self, name: str, documentation: str, typ: str):
        self.name = name
        self.documentation = documentation
        self.type = typ
        self.samples: List[Sample] = []

    def add_sample(self, name: str, labels: Dict[str, str], value: float) -> None:
        self.samples.append(Sample(name, labels, value))

    def __repr__(self) -> str:
        return (f"Metric({self.name!r}, {self.documentation!r}, {self.type!r}, "
                f"samples={self.samples!r})")


def float_to_go_string(d) -> str:
    """A float as the Go client writes it (prometheus_client's
    `floatToGoString`)."""
    d = float(d)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


class _Value:
    """A float behind a lock: what `._value` is in prometheus_client."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float) -> None:
        with self._lock:
            self._v += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    def get(self) -> float:
        with self._lock:
            return self._v


class CollectorRegistry:
    """Collectors by name; `collect()` walks them in registration order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._collectors: Dict[object, Tuple[str, ...]] = {}
        self._names: Dict[str, object] = {}

    def register(self, collector) -> None:
        names = collector._series_names()
        with self._lock:
            dup = [n for n in names if n in self._names]
            if dup:
                raise ValueError(f"Duplicated timeseries in CollectorRegistry: {set(dup)}")
            for n in names:
                self._names[n] = collector
            self._collectors[collector] = names

    def collect(self) -> Iterable[Metric]:
        with self._lock:
            collectors = list(self._collectors)
        for c in collectors:
            yield from c.collect()


REGISTRY = CollectorRegistry()


class _Collector:
    """What Counter, Gauge and Histogram share: the name, the labels and
    the children by label values."""

    _type = ""

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (), registry=REGISTRY,
                 _labelvalues: Optional[Tuple[str, ...]] = None):
        self._name = name
        self._documentation = documentation
        self._labelnames = tuple(labelnames)
        self._labelvalues = _labelvalues or ()
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], "_Collector"] = {}
        if not self._labelnames or self._labelvalues:
            self._init_value()
        if registry is not None and not self._labelvalues:
            registry.register(self)

    def _init_value(self) -> None:
        raise NotImplementedError

    def _series_names(self) -> Tuple[str, ...]:
        return (self._name,)

    def labels(self, *labelvalues, **labelkwargs):
        if not self._labelnames:
            raise ValueError(f"No label names were set when constructing {self!r}")
        if labelvalues and labelkwargs:
            raise ValueError("Can't pass both *args and **kwargs")
        if labelkwargs:
            if sorted(labelkwargs) != sorted(self._labelnames):
                raise ValueError("Incorrect label names")
            labelvalues = tuple(str(labelkwargs[n]) for n in self._labelnames)
        else:
            if len(labelvalues) != len(self._labelnames):
                raise ValueError("Incorrect label count")
            labelvalues = tuple(str(v) for v in labelvalues)
        with self._lock:
            child = self._children.get(labelvalues)
            if child is None:
                child = self._child(labelvalues)
                self._children[labelvalues] = child
            return child

    def _child(self, labelvalues):
        kwargs = {"registry": None, "_labelvalues": labelvalues}
        if isinstance(self, Histogram):
            kwargs["buckets"] = self._upper_bounds
        return type(self)(self._name, self._documentation, self._labelnames, **kwargs)

    def _child_samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        raise NotImplementedError

    def _family_name(self) -> str:
        return self._name

    def describe(self) -> List[Metric]:
        return [Metric(self._family_name(), self._documentation, self._type)]

    def collect(self) -> List[Metric]:
        metric = Metric(self._family_name(), self._documentation, self._type)
        if self._labelnames:
            with self._lock:
                children = list(self._children.items())
            for values, child in children:
                base = dict(zip(self._labelnames, values))
                for suffix, labels, value in child._child_samples():
                    metric.add_sample(self._family_name() + suffix, {**base, **labels}, value)
        else:
            for suffix, labels, value in self._child_samples():
                metric.add_sample(self._family_name() + suffix, labels, value)
        return [metric]

    def _check_unlabelled(self) -> None:
        if self._labelnames and not self._labelvalues:
            raise ValueError(f"{self._name} has labels: call .labels() first")

    def __repr__(self) -> str:
        return f"{type(self).__module__}.{type(self).__name__}({self._name})"


class Counter(_Collector):
    _type = "counter"

    def __init__(self, name: str, documentation: str, labelnames=(), registry=REGISTRY,
                 _labelvalues=None):
        if name.endswith("_total"):
            name = name[: -len("_total")]
        super().__init__(name, documentation, labelnames, registry, _labelvalues)

    def _init_value(self) -> None:
        self._value = _Value()

    def _series_names(self):
        return (self._name, self._name + "_total", self._name + "_created")

    def inc(self, amount: float = 1) -> None:
        self._check_unlabelled()
        if amount < 0:
            raise ValueError("Counters can only be incremented by non-negative amounts.")
        self._value.inc(amount)

    def _child_samples(self):
        return [("_total", {}, self._value.get())]


class Gauge(_Collector):
    _type = "gauge"

    def _init_value(self) -> None:
        self._value = _Value()

    def inc(self, amount: float = 1) -> None:
        self._check_unlabelled()
        self._value.inc(amount)

    def dec(self, amount: float = 1) -> None:
        self._check_unlabelled()
        self._value.inc(-amount)

    def set(self, value: float) -> None:
        self._check_unlabelled()
        self._value.set(value)

    def _child_samples(self):
        return [("", {}, self._value.get())]


class Histogram(_Collector):
    _type = "histogram"

    def __init__(self, name: str, documentation: str, labelnames=(), registry=REGISTRY,
                 buckets=(), _labelvalues=None):
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("Buckets not in sorted order")
        if not bounds or bounds[-1] != INF:
            bounds.append(INF)
        if len(bounds) < 2:
            raise ValueError("Must have at least two buckets")
        if "le" in labelnames:
            raise ValueError("Invalid label name: le")
        self._upper_bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry, _labelvalues)

    def _init_value(self) -> None:
        self._buckets = [_Value() for _ in self._upper_bounds]
        self._sum = _Value()

    def _series_names(self):
        return tuple(self._name + s for s in ("", "_bucket", "_count", "_sum", "_created"))

    def observe(self, amount: float) -> None:
        self._check_unlabelled()
        self._sum.inc(amount)
        for i, bound in enumerate(self._upper_bounds):
            if amount <= bound:
                self._buckets[i].inc(1)
                break

    def _child_samples(self):
        out = []
        acc = 0.0
        for bound, bucket in zip(self._upper_bounds, self._buckets):
            acc += bucket.get()
            out.append(("_bucket", {"le": float_to_go_string(bound)}, acc))
        out.append(("_count", {}, acc))
        if self._upper_bounds[0] >= 0:
            out.append(("_sum", {}, self._sum.get()))
        return out


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _sample_line(s: Sample) -> str:
    labelstr = ""
    if s.labels:
        labelstr = "{" + ",".join(
            f'{k}="{_escape_label_value(v)}"' for k, v in sorted(s.labels.items())
        ) + "}"
    return f"{s.name}{labelstr} {float_to_go_string(s.value)}\n"


def generate_latest(registry: CollectorRegistry = REGISTRY) -> bytes:
    """The registry in the text exposition format 0.0.4."""
    out: List[str] = []
    for metric in registry.collect():
        mname = metric.name + "_total" if metric.type == "counter" else metric.name
        doc = metric.documentation.replace("\\", r"\\").replace("\n", r"\n")
        out.append(f"# HELP {mname} {doc}\n")
        out.append(f"# TYPE {mname} {metric.type}\n")
        out.extend(_sample_line(s) for s in metric.samples)
    return "".join(out).encode("utf-8")
