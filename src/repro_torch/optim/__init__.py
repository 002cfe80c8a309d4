from repro_torch.optim.adamw import (AdamWConfig, AdamWState, cosine_schedule, global_norm,
                                     init, update)

__all__ = ["AdamWConfig", "AdamWState", "cosine_schedule", "global_norm", "init", "update"]
