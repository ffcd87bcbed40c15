"""Plain-PyTorch train step of a global-embedding classifier under
torchreid's softmax recipe (the ``osnet_x1_0`` configuration): the
random horizontal flip, the model, the label-smoothed cross entropy, the
backward and amsgrad as optax defines it (float32; the caller turns TF32
off).

The flip's draws are taken from a ``torch.Generator`` that the caller
seeds as it seeds the program's engine, one ``rand`` of the batch's size
a step as the program draws it (``draws``), so both sides flip the same
crops without either reading the other's tensors.

amsgrad (``AMSGrad``): optax's ``add_decayed_weights(wd)`` ->
``scale_by_amsgrad`` -> ``-lr`` chain, with its scalars on the host in
float32: with g = grad + wd p and t the step from 1, mu = (1 - b1) g +
b1 mu, nu = (1 - b2) g^2 + b2 nu, nu_max = max(nu_max, nu / (1 - b2^t)),
p = p - lr (mu / (1 - b1^t)) / (sqrt(nu_max) + eps). torchreid's
``amsgrad`` is ``torch.optim.Adam(amsgrad=True)``, which takes the
maximum of the second moment before its bias correction; the program
follows optax, as the JAX package does.

Departures from torchreid's recipe: torchreid flips a PIL image before
``ToTensor``; here a uint8 crop ``[H, W, 3]`` is flipped along W, scaled
to [0, 1] and normalized with the ImageNet mean and deviation.
"""
import numpy as np
import torch

from benchmark.reference.osnet import smoothed_ce
from benchmark.reference.train import MEAN, STD

__all__ = ['draws', 'augment', 'AMSGrad', 'train_step']

FLIP = ('random_flip', 'rf')


def draws(generator, n, transforms):
    """``{'flip': [n] bool or None}``, in the order the program draws
    them."""
    unknown = {t.lower() for t in transforms} - set(FLIP)
    if unknown:
        raise ValueError('the reference augments with random_flip only, '
                         'not {}'.format(sorted(unknown)))
    if not transforms:
        return {'flip': None}
    return {'flip': torch.rand(n, generator=generator,
                               device=generator.device) < 0.5}


def augment(images_u8, d):
    """uint8 ``[N, H, W, 3]`` -> the flipped, normalized float
    ``[N, 3, H, W]``."""
    x = images_u8.float() / 255.0
    if d['flip'] is not None:
        x = torch.where(d['flip'].to(x.device)[:, None, None, None],
                        x.flip(2), x)
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


class AMSGrad:
    """optax's amsgrad with L2 weight decay (see the module docstring); a
    parameter without a gradient gets a zero one. ``frozen_at``: a fault,
    the step count stopped there (the bias corrections of that step on
    every later one), as a CUDA graph that baked a host count into its
    capture would leave it."""

    def __init__(self, params, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8, frozen_at=None):
        self.params = list(params)
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.t = 0
        self.frozen_at = frozen_at
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        """Returns the gradients as the update took them."""
        self.t += 1
        t = self.t if self.frozen_at is None else min(self.t, self.frozen_at)
        f32 = np.float32
        c1 = float(f32(1) - f32(self.b1) ** f32(t))
        c2 = float(f32(1) - f32(self.b2) ** f32(t))
        taken = []
        for p, mu, nu, nu_max in zip(self.params, self.mu, self.nu,
                                     self.nu_max):
            g = (p.grad if p.grad is not None else torch.zeros_like(p)) \
                + self.wd * p
            taken.append(g)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            torch.maximum(nu_max, nu / c2, out=nu_max)
            p.sub_(self.lr * ((mu / c1) / (nu_max.sqrt() + self.eps)))
        return taken


def train_step(model, opt, images_u8, pids, d, eps=0.1):
    """One reference train step; returns ``(loss, loss gradients by
    parameter, gradients the update took)``."""
    model.train()
    loss = smoothed_ce(model(augment(images_u8, d)), pids, eps)
    for p in opt.params:
        p.grad = None
    loss.backward()
    grads = [None if p.grad is None else p.grad.detach().clone()
             for p in opt.params]
    taken = opt.step()
    return float(loss.detach()), grads, taken
