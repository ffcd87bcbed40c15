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
the step where rho reaches 5. Each group's step count is a float32
tensor on the parameters' device, advanced in place, and the step's
scalars (bias corrections, rho, the rectification) are computed from it
on that device in float32, in optax's order of operations, so radam
switches on at the same step as JAX and a CUDA graph of the train step
(``engine/graphs.py``) reads the current step on every replay; radam's
switch is a select, as optax's ``jnp.where``. The JAX version's
``flatten_bucketed`` is a TPU dispatch trick with the same math and has
no port.

Adam over parameters on a CUDA device is built ``capturable`` too: its
step count and bias corrections live on the device
(``torch.optim.Adam(capturable=True)``); eager Adam keeps the count on
the host, where a graph would freeze it. The bias corrections are then
computed in f32 on the device, not in f64 on the host, so the card's
updates differ from the CPU's in the last bits (on the CPU, Adam cannot
be capturable). SGD and ``OptaxRule`` read nothing on the host and are
captured as they are; the learning rates are part of a graph's key.
``is_capturable`` tells the engine which optimizers a graph may
capture.
"""
import torch

from bpbreid_tpu_torch.utils.tracing import span

__all__ = ['build_optimizer', 'AVAI_OPTIMS', 'OptaxRule', 'is_capturable']

AVAI_OPTIMS = ['adam', 'amsgrad', 'sgd', 'rmsprop', 'radam']
ADAM_EPS = 1e-8           # optax.scale_by_adam's default (and its kin's)
RADAM_THRESHOLD = 5.0     # optax.scale_by_radam's default


class OptaxRule(torch.optim.Optimizer):
    """optax's ``add_decayed_weights(wd)`` -> ``rule`` -> ``-lr`` chain
    (``bpbreid_tpu/optim/optimizer.py:125-133``) for ``rule`` in
    'amsgrad', 'rmsprop' and 'radam'. Each parameter group is updated by
    ``torch._foreach_*`` calls over its tensors with a gradient (a
    handful of launches a step); the group keeps one step count
    (``group['step']``), as optax keeps one ``count``: a float32 tensor
    on the group's device that each step advances in place (the scalars
    below are tensors on that device, computed under the span
    ``optim.scalars``).

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

    def add_param_group(self, param_group):
        super().add_param_group(param_group)
        group = self.param_groups[-1]
        group['step'] = _device_step(group, group['step'])

    def load_state_dict(self, state_dict):
        """Each group's count as a new float32 tensor on its parameters'
        device, whatever the saved one was (a tensor on another device,
        or an int as older checkpoints hold it): a CUDA graph keyed on
        the old count's address is captured anew."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            group['step'] = _device_step(group, group['step'])

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
            if not params:
                continue
            with span('optim.scalars'):
                group['step'].add_(1)
                scalars = self._scalars(group, group['step'])
            self._update(group, params, scalars)
        return loss

    def _scalars(self, group, t):
        """The step's scalars as float32 tensors on ``t``'s device, from
        the step count ``t`` there: ``(1 - b1^t, 1 - b2^t)``, and for
        radam its rectification r and its switch ``on`` (1.0 where rho
        >= 5, else 0.0 with r 0.0); None for rmsprop, which reads
        none."""
        if self.rule == 'rmsprop':
            return None
        c1 = 1.0 - torch.pow(group['b1'], t)
        b2t = torch.pow(group['b2'], t)
        c2 = 1.0 - b2t
        if self.rule == 'amsgrad':
            return c1, c2
        ro_inf = 2.0 / (1.0 - group['b2']) - 1.0
        ro = ro_inf - (2.0 * t) * b2t / c2
        on = ro >= RADAM_THRESHOLD
        q = (ro - 4.0) * (ro - 2.0) * ro_inf / ((ro_inf - 4.0)
                                               * (ro_inf - 2.0) * ro)
        # the square root rounded once to float32, as optax's (the CPU's
        # float32 sqrt can miss by an ulp; through float64 it cannot)
        r = torch.sqrt(q.double()).float()
        # r is NaN where 2 < rho < 4: zero it where it is not used
        return c1, c2, torch.where(on, r, 0.0), on.float()

    def _update(self, group, params, scalars):
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
        mu_hat = torch._foreach_div(mus, scalars[0])
        nu_hat = torch._foreach_div(nus, scalars[1])
        if self.rule == 'amsgrad':
            nu_max = [st['nu_max'] for st in sts]
            torch._foreach_maximum_(nu_max, nu_hat)
            nu_hat = nu_max
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, group['eps'])
        if self.rule == 'amsgrad':
            torch._foreach_add_(params, torch._foreach_div(mu_hat, denom),
                                alpha=-group['lr'])
            return
        # radam: r mu_hat / denom where rho >= 5, else mu_hat, as optax's
        # jnp.where; each term times 1 or 0, so either is taken exactly
        r, on = scalars[2:]
        rect = torch._foreach_mul(mu_hat, r)
        torch._foreach_div_(rect, denom)
        torch._foreach_mul_(rect, on)
        torch._foreach_mul_(mu_hat, 1.0 - on)
        torch._foreach_add_(rect, mu_hat)
        torch._foreach_add_(params, rect, alpha=-group['lr'])


def _device_step(group, step):
    """``step`` (a number or a tensor) as a float32 tensor on the
    group's parameters' device (the CPU for an empty group)."""
    device = group['params'][0].device if group['params'] else 'cpu'
    return torch.full((), float(step), dtype=torch.float32, device=device)


def is_capturable(optimizer):
    """Whether a CUDA graph may capture ``optimizer``'s step: SGD or an
    ``OptaxRule``, which read nothing on the host, or an Adam all of
    whose groups are ``capturable``."""
    if isinstance(optimizer, (torch.optim.SGD, OptaxRule)):
        return True
    return bool(optimizer.param_groups) and all(
        g.get('capturable', False) for g in optimizer.param_groups)


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
