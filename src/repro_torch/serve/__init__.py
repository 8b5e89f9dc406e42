"""The serving layer of the port: token-level continuous batching over
decode slots (:class:`ServeEngine`) under the paper's Theorem 4.2
FIFO/bounded-I/O discipline."""
from .engine import Request, ServeConfig, ServeEngine

__all__ = ["ServeEngine", "Request", "ServeConfig"]
