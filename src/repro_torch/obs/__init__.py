"""repro_torch.obs — host-side metrics and tracing, copies of the JAX
package's ``obs.registry`` and ``obs.trace`` (which hold no JAX, but the
port imports nothing of ``repro``).  The in-graph ``obs.metrics``
telemetry (``stats=True``) is not ported (ROADMAP.md queue 1 item 8)."""

from repro_torch.obs import registry, trace
from repro_torch.obs.registry import REGISTRY
from repro_torch.obs.trace import Tracer

__all__ = ["registry", "trace", "REGISTRY", "Tracer"]
