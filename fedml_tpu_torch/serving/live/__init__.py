"""Live weights of the port's serving engine (hot-swap model slots)."""
from fedml_tpu_torch.serving.live.slots import ModelSlots, SlotLease

__all__ = ["ModelSlots", "SlotLease"]
