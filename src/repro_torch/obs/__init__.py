"""repro_torch.obs — the engines' tracer hook (the no-op default so far)."""
from .trace import NULL_TRACER, NullTracer, round_event

__all__ = ["NULL_TRACER", "NullTracer", "round_event"]
