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

The other optimizers of the JAX version (amsgrad, rmsprop, radam) have
no exact torch counterpart (optax takes the amsgrad maximum after bias
correction and puts rmsprop's eps inside the square root) and are not
ported yet. The JAX version's ``flatten_bucketed`` is a TPU dispatch
trick with the same math and has no port.
"""
import torch

__all__ = ['build_optimizer', 'AVAI_OPTIMS']

AVAI_OPTIMS = ['adam', 'sgd']
ADAM_EPS = 1e-8           # optax.scale_by_adam's default


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
        optim: 'adam' or 'sgd'.
        staged_lr: scale the base layers' lr by ``base_lr_mult``.
    """
    del sgd_dampening, rmsprop_alpha, kwargs
    if optim not in AVAI_OPTIMS:
        raise NotImplementedError(
            "optimizer '{}' is not ported yet (ported: {})".format(
                optim, ', '.join(AVAI_OPTIMS)))
    groups = _param_groups(model, lr, staged_lr, new_layers, base_lr_mult)
    if optim == 'adam':
        return torch.optim.Adam(groups, lr=lr,
                                betas=(adam_beta1, adam_beta2),
                                eps=ADAM_EPS, weight_decay=weight_decay)
    return torch.optim.SGD(groups, lr=lr, momentum=momentum, dampening=0.0,
                           nesterov=sgd_nesterov and momentum > 0,
                           weight_decay=weight_decay)
