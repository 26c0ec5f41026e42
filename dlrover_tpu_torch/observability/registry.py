"""In-process metrics registry with Prometheus text export.

The port's trim of ``dlrover_tpu/observability/registry.py`` to what the
serving plane publishes: counters, gauges (with ``set_function`` for
values computed at scrape time) and histograms, each with labels, and
:meth:`MetricsRegistry.render` in the Prometheus text format. The serving
modules register the reference's ``dlrover_serving_*`` families under the
same names and buckets, so a scrape reads a port replica as it reads a
JAX one. A histogram's :meth:`Histogram.bucket_counts` feeds the SLO
plane, and collect hooks (the journal's phase gauges) run before each
render. A histogram keeps, per bucket, the exemplar of the last
observation that carried one (``observe(value, exemplar=trace_id)``),
rendered in the OpenMetrics form the reference renders
(``... # {trace_id="..."} value``), so a slow bucket links to a request's
trace.
"""

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from dlrover_tpu_torch.common.log import logger

_DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0,
)


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n").replace(
        '"', '\\"')


def _render_labels(pairs) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"'
                          for k, v in pairs) + "}"


class _Metric:
    """One family: name, help and label names; a child per label-value
    tuple (a family without labels is its own only child)."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str = "",
                 labelnames: Sequence[str] = ()):
        if not name or not all(c.isalnum() or c in "_:" for c in name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        self._init_value()

    def _init_value(self) -> None:
        raise NotImplementedError

    def _child(self) -> "_Metric":
        return type(self)(self.name, self.help)

    def labels(self, *values, **kv) -> "_Metric":
        if kv:
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._child()
                self._children[values] = child
            return child

    def _own_samples(self, labels):
        raise NotImplementedError

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}"] if self.help else []
        lines.append(f"# TYPE {self.name} {self.kind}")
        samples = [] if self.labelnames else self._own_samples(())
        with self._lock:
            children = list(self._children.items())
        for values, child in children:
            samples += child._own_samples(tuple(zip(self.labelnames,
                                                    values)))
        for suffix, labels, value, *exemplar in samples:
            line = (f"{self.name}{suffix}{_render_labels(labels)} "
                    f"{_format_value(value)}")
            if exemplar and exemplar[0] is not None:
                ex_id, ex_val = exemplar[0]
                line += (f' # {{trace_id="{_escape_label(ex_id)}"}} '
                         f"{_format_value(ex_val)}")
            lines.append(line)
        return "\n".join(lines)


class Counter(_Metric):
    kind = "counter"

    def _init_value(self) -> None:
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _own_samples(self, labels):
        return [("", labels, self.value)]


class Gauge(_Metric):
    kind = "gauge"

    def _init_value(self) -> None:
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Compute the value at scrape time."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:  # noqa: BLE001 — a broken callback reads NaN
            logger.debug("gauge %s callback failed", self.name,
                         exc_info=True)
            return float("nan")

    def _own_samples(self, labels):
        return [("", labels, self.value)]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        self._buckets = tuple(sorted(buckets))
        super().__init__(name, help_text, labelnames)

    def _init_value(self) -> None:
        self._counts = [0] * (len(self._buckets) + 1)  # + the +Inf bucket
        self._sum = 0.0
        self._count = 0
        # bucket index → (trace_id, value) of its last exemplar
        self._exemplars: Dict[int, Tuple[str, float]] = {}

    def _child(self) -> "Histogram":
        return Histogram(self.name, self.help, buckets=self._buckets)

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self._buckets):
                if value <= b:
                    self._counts[i] += 1
                    if exemplar:
                        self._exemplars[i] = (str(exemplar), value)
                    return
            self._counts[-1] += 1
            if exemplar:
                self._exemplars[len(self._buckets)] = (str(exemplar), value)

    def exemplars(self) -> Dict[float, Tuple[str, float]]:
        """{bucket upper bound → (trace_id, observed value)} of the
        buckets holding one; the +Inf bucket keys ``math.inf``."""
        with self._lock:
            snap = dict(self._exemplars)
        bounds = list(self._buckets) + [math.inf]
        return {bounds[i]: ex for i, ex in snap.items()}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def bucket_counts(self) -> Dict[float, int]:
        """Cumulative observations per upper bound; the +Inf bucket keys
        ``math.inf`` and equals the count. The SLO plane diffs these
        snapshots over its windows."""
        with self._lock:
            counts = list(self._counts)
        out: Dict[float, int] = {}
        cum = 0
        for b, c in zip(self._buckets, counts[:-1]):
            cum += c
            out[b] = cum
        out[math.inf] = cum + counts[-1]
        return out

    def _own_samples(self, labels):
        with self._lock:
            counts, total, s = list(self._counts), self._count, self._sum
            exemplars = dict(self._exemplars)
        out, cum = [], 0
        for i, (b, c) in enumerate(zip(self._buckets, counts)):
            cum += c
            out.append(("_bucket", labels + (("le", _format_value(b)),),
                        float(cum), exemplars.get(i)))
        out.append(("_bucket", labels + (("le", "+Inf"),), float(total),
                    exemplars.get(len(self._buckets))))
        out.append(("_sum", labels, s))
        out.append(("_count", labels, float(total)))
        return out


class MetricsRegistry:
    """Get-or-create metric families and their Prometheus text."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._hooks: List[Callable[[], None]] = []

    def _get_or_create(self, cls, name, help_text, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_text, labelnames, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name} already registered as "
                                 f"{m.kind}")
            return m

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help_text, labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labelnames,
                                   buckets=buckets)

    def add_collect_hook(self, fn: Callable[[], None]) -> None:
        """``fn()`` runs before every render, to refresh gauges it owns."""
        with self._lock:
            self._hooks.append(fn)

    def remove_collect_hook(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._hooks:
                self._hooks.remove(fn)

    def render(self) -> str:
        """The Prometheus text exposition of every family."""
        with self._lock:
            hooks = list(self._hooks)
            metrics = sorted(self._metrics.items())
        for fn in hooks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a bad hook must not break
                logger.warning("metrics collect hook %r failed; rendering "
                               "without its update", fn, exc_info=True)
        body = "\n".join(m.render() for _, m in metrics)
        return body + "\n" if body else ""


_default_registry: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = MetricsRegistry()
        return _default_registry
