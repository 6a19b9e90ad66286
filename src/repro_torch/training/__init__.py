"""Training runtime: optimizer, train step, synthetic data pipeline.

Port of ``repro/training``: AdamW with its cosine schedule and global
norm clipping, the train step (remat, microbatch accumulation, int8
gradient compression) and the numpy-seeded synthetic batches, on one
device or on a mesh of ranks (each rank's blocks of a ``Model.shard``
model, its gradients summed over the batch's ranks).
"""
from repro_torch.training.data import prefetch_iterator, synthetic_batch
from repro_torch.training.optimizer import (
    AdamWState,
    Optimizer,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
)
from repro_torch.training.train_step import int8_compress, make_train_step

__all__ = [
    "adamw", "cosine_schedule", "global_norm", "clip_by_global_norm",
    "AdamWState", "Optimizer", "make_train_step", "int8_compress",
    "synthetic_batch", "prefetch_iterator",
]
