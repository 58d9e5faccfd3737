"""Local (client-side) optimizers and learning-rate schedules (the port of
``repro.optim``)."""
from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates, get_optimizer, sgd
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "Optimizer",
    "adamw",
    "apply_updates",
    "sgd",
    "get_optimizer",
    "constant",
    "cosine_decay",
    "linear_warmup_cosine",
]
