from repro_torch.optim import schedule
from repro_torch.optim.optimizer import (Optimizer, adam, clip_by_global_norm,
                                         sgd)

__all__ = ["Optimizer", "adam", "sgd", "clip_by_global_norm", "schedule"]
