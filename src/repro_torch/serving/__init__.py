"""The port's serving stack: COREC/RSS ingestion feeding the decode-slot
engine (``from repro_torch.serving import EngineConfig, InferenceEngine``).
``request`` and ``scheduler`` are own copies of the reference's JAX-free
modules."""

from .engine import EngineConfig, InferenceEngine
from .request import Request, RequestResult
from .scheduler import CorecScheduler, RssScheduler, make_scheduler

__all__ = [
    "Request",
    "RequestResult",
    "CorecScheduler",
    "RssScheduler",
    "make_scheduler",
    "InferenceEngine",
    "EngineConfig",
]
