"""Training substrate: optimizer, step functions, checkpointing, data."""

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import ProxyPrefetcher, synthetic_batch
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_opt_state
from repro_torch.train.train_step import init_train_state, make_train_step

__all__ = [
    "CheckpointManager",
    "ProxyPrefetcher",
    "synthetic_batch",
    "AdamWConfig",
    "apply_updates",
    "init_opt_state",
    "init_train_state",
    "make_train_step",
]
