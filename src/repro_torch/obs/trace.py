"""Span tracer: wall-time spans, latency histograms, JSONL events.

The port's copy of ``repro.obs.trace``.

A ``Tracer`` times named spans with ``time.perf_counter`` and feeds each
duration into a per-span-name latency ``Histogram`` in a ``Registry``
(p50/p95/p99 readable at any time), optionally appending one JSONL event
per span/event to a file.

The JSONL **event schema** is the JAX package's (``launch.report``
renders it)::

    {"event": str,          # span or event name
     "t_s": float,          # start time, perf_counter seconds
     "dur_s": float,        # span duration (0.0 for point events)
     ...fields}             # caller-supplied scalar fields

``EVENT_FIELDS`` lists the required keys; ``is_event``/``validate_event``
are the shared predicates report-side code uses to recognize them.
"""

from __future__ import annotations

import contextlib
import json
import time

from repro_torch.obs import registry as _registry

#: required keys of one trace JSONL record
EVENT_FIELDS = ("event", "t_s", "dur_s")


def is_event(record: dict) -> bool:
    return all(k in record for k in EVENT_FIELDS)


def validate_event(record: dict) -> None:
    for k in EVENT_FIELDS:
        if k not in record:
            raise ValueError(f"trace event missing {k!r}: {record}")
    if not isinstance(record["event"], str):
        raise ValueError(f"trace event name must be a string: {record}")
    for k in ("t_s", "dur_s"):
        float(record[k])


class Tracer:
    """Times spans; ``span(name)`` is a context manager.

    Durations land in ``registry.histogram(f"{name}.latency_s")`` (the
    process ``REGISTRY`` by default) so p50/p95/p99 are free; with
    ``jsonl_path`` every span/event also appends one schema-conforming
    JSONL line.  A disabled tracer (``enabled=False``) is free: span() is
    a no-op context.  A span times the host: a caller timing work on the
    card synchronises inside the span."""

    def __init__(self, registry: _registry.Registry | None = None,
                 jsonl_path: str | None = None, enabled: bool = True):
        self.registry = registry if registry is not None \
            else _registry.REGISTRY
        self.jsonl_path = jsonl_path
        self.enabled = enabled
        self._sink = None

    def _emit(self, record: dict) -> None:
        if not self.jsonl_path:
            return
        if self._sink is None:
            self._sink = open(self.jsonl_path, "a")
        self._sink.write(json.dumps(record) + "\n")
        self._sink.flush()

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Time a block; record latency + optional JSONL event."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            self.registry.histogram(f"{name}.latency_s").record(dur)
            self._emit({"event": name, "t_s": t0, "dur_s": dur, **fields})

    def event(self, name: str, **fields) -> None:
        """Point event (no duration)."""
        if not self.enabled:
            return
        self._emit({"event": name, "t_s": time.perf_counter(),
                    "dur_s": 0.0, **fields})

    def percentiles(self, name: str) -> dict:
        """{p50_s, p95_s, p99_s, count} for one span name."""
        return self.registry.histogram(f"{name}.latency_s").summary()

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None


def load_events(path: str) -> list[dict]:
    """Read a trace JSONL file, validating each record against the schema."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            validate_event(rec)
            out.append(rec)
    return out
