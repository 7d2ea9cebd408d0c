"""repro_torch.obs — host-side metrics and tracing, copies of the JAX
package's ``obs.registry`` and ``obs.trace`` (which hold no JAX, but the
port imports nothing of ``repro``), and ``obs.metrics``, the port of the
table telemetry that ``stats=True`` returns (``TableStats``)."""

from repro_torch.obs import metrics, registry, trace
from repro_torch.obs.metrics import TableStats
from repro_torch.obs.registry import REGISTRY
from repro_torch.obs.trace import Tracer

__all__ = ["metrics", "registry", "trace", "REGISTRY", "TableStats", "Tracer"]
