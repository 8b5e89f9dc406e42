"""The serving layer of the port: token-level continuous batching over
decode slots (:class:`ServeEngine`) and query-level continuous batching over
the plan cache (:class:`QueryService`), both under the paper's Theorem 4.2
FIFO/bounded-I/O discipline, sharing the injectable-clock protocol
(:class:`VirtualClock` for determinism).

The load generator lives one import deeper (``repro_torch.serve.loadgen``).
"""
from .engine import Request, ServeConfig, ServeEngine
from .mr import DispatchError, QueryService, Ticket, QueueFull, VirtualClock

__all__ = [
    "ServeEngine", "Request", "ServeConfig",
    "DispatchError", "QueryService", "Ticket", "QueueFull", "VirtualClock",
]
