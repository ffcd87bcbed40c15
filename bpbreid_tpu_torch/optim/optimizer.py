"""Optimizer factory (port of bpbreid_tpu/optim/optimizer.py).

The JAX version chains ``add_decayed_weights(wd)`` -> ``scale_by_adam``
-> ``-lr``: torch-style coupled weight decay, the L2 term added to the
gradient before the moments, and eps outside the square root. That is
``torch.optim.Adam(weight_decay=wd, eps=1e-8)`` (held against optax in
``tests/test_torch_train_losses.py``). SGD with momentum is
``optax.trace`` -> ``torch.optim.SGD`` (no dampening, as in the JAX
version). ``staged_lr`` makes two parameter groups: parameters whose
name holds any of ``new_layers`` at ``lr``, the rest at
``lr * base_lr_mult``; each group keeps its ``lr_mult`` for the
schedule (``lr_scheduler.py``).

amsgrad, rmsprop and radam are ``OptaxRule``: optax's own update rules
(``scale_by_amsgrad``, ``scale_by_rms``, ``scale_by_radam``), written
here by hand because ``torch.optim``'s differ: optax's amsgrad takes the
maximum of the bias-corrected second moment, its rmsprop divides by
``sqrt(nu + eps)`` without bias correction, and its radam rectifies from
the step where rho reaches 5. The step's scalars (bias corrections,
rho, the rectification) are computed on the host in float32, in optax's
order of operations, so radam switches on at the same step as JAX; so
its step cannot run inside a CUDA graph. The JAX version's
``flatten_bucketed`` is a TPU dispatch trick with the same math and has
no port.

Adam over parameters on a CUDA device is built ``capturable``: its step
count and bias corrections live on the device
(``torch.optim.Adam(capturable=True)``), as a CUDA graph of the train
step needs (``engine/graphs.py``); eager Adam keeps the count on the
host, where a graph would freeze it. The bias corrections are then
computed in f32 on the device, not in f64 on the host, so the card's
updates differ from the CPU's in the last bits (on the CPU, Adam cannot
be capturable). SGD reads nothing on the host and is captured as it is;
the learning rates are part of a graph's key.
"""
import numpy as np
import torch

__all__ = ['build_optimizer', 'AVAI_OPTIMS', 'OptaxRule']

AVAI_OPTIMS = ['adam', 'amsgrad', 'sgd', 'rmsprop', 'radam']
ADAM_EPS = 1e-8           # optax.scale_by_adam's default (and its kin's)
RADAM_THRESHOLD = 5.0     # optax.scale_by_radam's default


class OptaxRule(torch.optim.Optimizer):
    """optax's ``add_decayed_weights(wd)`` -> ``rule`` -> ``-lr`` chain
    (``bpbreid_tpu/optim/optimizer.py:125-133``) for ``rule`` in
    'amsgrad', 'rmsprop' and 'radam'. Each parameter group is updated by
    ``torch._foreach_*`` calls over its tensors with a gradient (a
    handful of launches a step); the group keeps one step count
    (``group['step']``), as optax keeps one ``count``.

    With g = grad + wd * p and t the step (from 1):
    - amsgrad: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2,
      nu_max = max(nu_max, nu / (1 - b2^t)),
      u = (mu / (1 - b1^t)) / (sqrt(nu_max) + eps);
    - rmsprop: nu = alpha nu + (1 - alpha) g^2, u = g / sqrt(nu + eps);
    - radam: mu, nu as amsgrad; rho = rho_inf - 2 t b2^t / (1 - b2^t),
      rho_inf = 2 / (1 - b2) - 1; with rho >= 5,
      u = r mu_hat / (sqrt(nu_hat) + eps), r = sqrt((rho - 4) (rho - 2)
      rho_inf / ((rho_inf - 4) (rho_inf - 2) rho)); else u = mu_hat;
    then p = p - lr u.
    """

    def __init__(self, params, rule, lr=0.0003, weight_decay=0.0, b1=0.9,
                 b2=0.999, alpha=0.99, eps=ADAM_EPS):
        if rule not in ('amsgrad', 'rmsprop', 'radam'):
            raise ValueError('unknown rule {}'.format(rule))
        self.rule = rule
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      b1=b1, b2=b2, alpha=alpha, eps=eps,
                                      step=0))

    def _state(self, p):
        st = self.state[p]
        if not st:
            names = {'rmsprop': ('nu',), 'radam': ('nu', 'mu'),
                     'amsgrad': ('nu', 'mu', 'nu_max')}[self.rule]
            st.update({n: torch.zeros_like(p) for n in names})
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group['params'] if p.grad is not None]
            if params:
                group['step'] += 1
                self._update(group, params, group['step'])
        return loss

    def _update(self, group, params, t):
        f32 = np.float32
        sts = [self._state(p) for p in params]
        grads = [p.grad for p in params]
        if group['weight_decay'] > 0:
            grads = torch._foreach_add(grads, params,
                                       alpha=group['weight_decay'])
        nus = [st['nu'] for st in sts]
        decay = group['alpha'] if self.rule == 'rmsprop' else group['b2']
        torch._foreach_mul_(nus, decay)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - decay)
        if self.rule == 'rmsprop':
            denom = torch._foreach_add(nus, group['eps'])
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(params, torch._foreach_div(grads, denom),
                                alpha=-group['lr'])
            return
        mus = [st['mu'] for st in sts]
        torch._foreach_mul_(mus, group['b1'])
        torch._foreach_add_(mus, grads, alpha=1.0 - group['b1'])
        b1t, b2t = f32(group['b1']) ** f32(t), f32(group['b2']) ** f32(t)
        mu_hat = torch._foreach_div(mus, float(f32(1) - b1t))
        nu_hat = torch._foreach_div(nus, float(f32(1) - b2t))
        if self.rule == 'amsgrad':
            nu_max = [st['nu_max'] for st in sts]
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        else:                                   # radam
            ro_inf = 2.0 / (1.0 - group['b2']) - 1.0
            ro = f32(ro_inf) - f32(2 * t) * b2t / (f32(1) - b2t)
            if ro < RADAM_THRESHOLD:
                torch._foreach_add_(params, mu_hat, alpha=-group['lr'])
                return
            r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * f32(ro_inf)
                        / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
            torch._foreach_mul_(mu_hat, float(r))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, group['eps'])
        torch._foreach_add_(params, torch._foreach_div(mu_hat, denom),
                            alpha=-group['lr'])


def _param_groups(model, lr, staged_lr, new_layers, base_lr_mult):
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if not staged_lr:
        return [{'params': [p for _, p in named], 'lr': lr, 'lr_mult': 1.0}]
    if isinstance(new_layers, str):
        new_layers = [new_layers]
    new = [p for n, p in named if any(nl and nl in n for nl in new_layers)]
    base = [p for n, p in named if not any(nl and nl in n
                                           for nl in new_layers)]
    return [{'params': new, 'lr': lr, 'lr_mult': 1.0},
            {'params': base, 'lr': lr * base_lr_mult,
             'lr_mult': base_lr_mult}]


def build_optimizer(model, optim='adam', lr=0.0003, weight_decay=5e-4,
                    momentum=0.9, sgd_dampening=0, sgd_nesterov=False,
                    rmsprop_alpha=0.99, adam_beta1=0.9, adam_beta2=0.999,
                    staged_lr=False, new_layers='', base_lr_mult=0.1,
                    **kwargs):
    """Build a ``torch.optim`` optimizer over ``model``'s parameters.

    Args:
        model: ``nn.Module`` (parameter names decide the staged groups).
        optim: one of ``AVAI_OPTIMS``.
        staged_lr: scale the base layers' lr by ``base_lr_mult``.
    """
    del sgd_dampening, kwargs
    if optim not in AVAI_OPTIMS:
        raise ValueError('Unsupported optimizer: {}. Must be one of {}'
                         .format(optim, AVAI_OPTIMS))
    groups = _param_groups(model, lr, staged_lr, new_layers, base_lr_mult)
    if optim in ('amsgrad', 'rmsprop', 'radam'):
        return OptaxRule(groups, optim, lr=lr, weight_decay=weight_decay,
                         b1=adam_beta1, b2=adam_beta2, alpha=rmsprop_alpha)
    if optim == 'adam':
        on_cuda = any(p.device.type == 'cuda'
                      for g in groups for p in g['params'])
        return torch.optim.Adam(groups, lr=lr,
                                betas=(adam_beta1, adam_beta2),
                                eps=ADAM_EPS, weight_decay=weight_decay,
                                capturable=on_cuda)
    return torch.optim.SGD(groups, lr=lr, momentum=momentum, dampening=0.0,
                           nesterov=sgd_nesterov and momentum > 0,
                           weight_decay=weight_decay)
