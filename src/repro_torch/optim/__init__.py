from .adamw import AdamW, OptState, apply_updates, global_norm
from .schedules import cosine_schedule, wsd_schedule

__all__ = [
    "AdamW",
    "OptState",
    "apply_updates",
    "global_norm",
    "cosine_schedule",
    "wsd_schedule",
]
