from .adamw import AdamW, OptState, apply_updates, global_norm
from .compress import (
    compressed_pod_allreduce,
    dequantize_int8,
    error_feedback_init,
    quantize_int8,
)
from .schedules import cosine_schedule, wsd_schedule

__all__ = [
    "AdamW",
    "OptState",
    "apply_updates",
    "global_norm",
    "cosine_schedule",
    "wsd_schedule",
    "quantize_int8",
    "dequantize_int8",
    "error_feedback_init",
    "compressed_pod_allreduce",
]
