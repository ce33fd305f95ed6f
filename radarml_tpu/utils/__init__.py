from radarml_tpu.utils.profiling import (
    RateMeter,
    StageTimer,
    card_name_and_power_limit,
    device_trace,
)

__all__ = [
    "RateMeter", "StageTimer", "card_name_and_power_limit", "device_trace",
]
