"""Host-side metrics registry: named counters, gauges, histograms.

The port's copy of ``repro.obs.registry``.  The process-wide ``REGISTRY``
is the rendezvous between instrumented library code (``core.migrate``'s
``table.*`` counters, ``core.snapshot``'s ``snapshot.*``, the elastic
service's ``elastic.*``) and whoever reads the signals.

A recorded value may be a Python number or a one-element torch tensor
(read with ``.item()``, which waits for the card); anything else that
does not convert to a float is ignored, so instrumentation never breaks
a caller.
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import torch


def _concrete(value):
    """float(value) for a number or a one-element tensor, else None."""
    if isinstance(value, torch.Tensor):
        if value.numel() != 1:
            return None
        value = value.item()
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


@dataclasses.dataclass
class Counter:
    name: str
    value: float = 0.0

    def inc(self, amount=1) -> None:
        v = _concrete(amount)
        if v is not None:
            self.value += v


@dataclasses.dataclass
class Gauge:
    name: str
    value: float = float("nan")

    def set(self, value) -> None:
        v = _concrete(value)
        if v is not None:
            self.value = v


class Histogram:
    """Reservoir-free latency histogram: keeps every sample (these are
    per-span wall times, thousands at most) and answers percentiles
    exactly."""

    def __init__(self, name: str):
        self.name = name
        self.samples: list[float] = []

    def record(self, value) -> None:
        v = _concrete(value)
        if v is not None and math.isfinite(v):
            self.samples.append(v)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(sum(self.samples))

    def percentile(self, q: float) -> float:
        """q in [0, 100]; nan when empty."""
        if not self.samples:
            return float("nan")
        return float(np.percentile(np.asarray(self.samples), q))

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0}
        return {"count": self.count, "sum_s": self.sum,
                "p50_s": self.percentile(50), "p95_s": self.percentile(95),
                "p99_s": self.percentile(99)}


class Registry:
    """Named metric store.  ``counter``/``gauge``/``histogram`` create on
    first use and return the same object afterwards (a name is bound to
    one kind; rebinding raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    f"not a {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict:
        """{name: value | histogram summary} for every registered metric."""
        out = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            if isinstance(m, (Counter, Gauge)):
                out[name] = m.value
            else:
                out[name] = m.summary()
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def render(self) -> str:
        """Human-readable one-metric-per-line dump (examples' printout)."""
        lines = []
        for name in sorted(self.snapshot()):
            v = self.snapshot()[name]
            if isinstance(v, dict):
                if not v.get("count"):
                    lines.append(f"{name}: (no samples)")
                else:
                    lines.append(
                        f"{name}: n={v['count']} p50={v['p50_s'] * 1e3:.3f}ms"
                        f" p95={v['p95_s'] * 1e3:.3f}ms"
                        f" p99={v['p99_s'] * 1e3:.3f}ms")
            else:
                lines.append(f"{name}: {v:g}")
        return "\n".join(lines)


#: process-wide default registry (library instrumentation records here)
REGISTRY = Registry()
