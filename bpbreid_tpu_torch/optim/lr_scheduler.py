"""Epoch-stepped learning-rate schedules (port of
bpbreid_tpu/optim/lr_scheduler.py): single_step, multi_step,
warmup_multi_step (linear warmup over ``warmup_iters`` epochs from
``warmup_factor``, then x``gamma`` decays) and cosine.

``LRSchedule`` maps ``epoch -> lr``; ``set_in_optimizer`` writes it into
each parameter group of a ``torch.optim`` optimizer, scaled by the
group's ``lr_mult`` (``optimizer.py``), once per epoch.
"""
import math

__all__ = ['build_lr_scheduler', 'LRSchedule', 'AVAI_SCH']

AVAI_SCH = ['single_step', 'multi_step', 'warmup_multi_step', 'cosine']


class LRSchedule:
    def __init__(self, fn, base_lr):
        self.fn = fn
        self.base_lr = base_lr

    def __call__(self, epoch):
        return self.fn(epoch)

    def set_in_optimizer(self, optimizer, epoch):
        """Write lr(epoch) (times each group's ``lr_mult``) into
        ``optimizer``."""
        lr = self(epoch)
        for group in optimizer.param_groups:
            group['lr'] = lr * group.get('lr_mult', 1.0)
        return optimizer


def build_lr_scheduler(lr=0.0003, lr_scheduler='single_step', stepsize=1,
                       gamma=0.1, max_epoch=1, warmup_iters=10,
                       warmup_factor=0.01, **kwargs):
    del kwargs
    if isinstance(stepsize, int):
        stepsize = [stepsize]

    if lr_scheduler == 'single_step':
        step = stepsize[-1]

        def fn(epoch):
            return lr * (gamma ** (epoch // step))
    elif lr_scheduler == 'multi_step':
        def fn(epoch):
            return lr * (gamma ** sum(epoch >= s for s in stepsize))
    elif lr_scheduler == 'warmup_multi_step':
        def fn(epoch):
            if epoch < warmup_iters:
                alpha = epoch / warmup_iters
                warm = warmup_factor * (1 - alpha) + alpha
            else:
                warm = 1.0
            return lr * warm * (gamma ** sum(epoch >= s for s in stepsize))
    elif lr_scheduler == 'cosine':
        def fn(epoch):
            return 0.5 * lr * (1 + math.cos(math.pi * epoch / max_epoch))
    else:
        raise ValueError('Unsupported scheduler: {}. Must be one of {}'
                         .format(lr_scheduler, AVAI_SCH))
    return LRSchedule(fn, lr)
