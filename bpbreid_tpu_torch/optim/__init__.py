"""Optimizer and learning-rate schedule (port of bpbreid_tpu/optim/)."""
from bpbreid_tpu_torch.optim.lr_scheduler import (LRSchedule,
                                                  build_lr_scheduler)
from bpbreid_tpu_torch.optim.optimizer import build_optimizer

__all__ = ['build_optimizer', 'build_lr_scheduler', 'LRSchedule']
