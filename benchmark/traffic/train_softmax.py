"""Traffic kind ``train_softmax``: torchreid's softmax recipe on a
global-embedding model of the zoo (the ``osnet_x1_0`` configuration):
the port's ``ImageSoftmaxEngine`` and its ``forward_backward_multi`` on
groups of ``steps_per_dispatch`` steps, back to back (a closed loop),
through the train step's CUDA graph on the card.

Set-up draws a pool of ``pool_groups`` groups of distinct seeded batches
(``ids`` x ``instances`` crops, a random template per identity plus
noise, as ``benchmark/data.py`` draws them, and no fields) and keeps it
pinned on the host, makes the weights from the configuration's plain
reference, builds the engine through the port's public constructors
(``models.build_model``, ``optim.build_optimizer``,
``ImageSoftmaxEngine``; a small object carries the data manager's
``transforms``, ``norm_mean`` and ``norm_std``), and runs the first
three steps through the window's own call (``forward_backward_multi``,
one step a call, on the pool's first three batches): the first runs
eagerly, the second captures the graph, the third replays it. Their
losses, the first gradient (from amsgrad's first moment ``mu`` after
step 1), the identity head's gradient of each step (from the first
moment's change over the step), the parameters' change after step 3 and
the third step's own change are read as the program left them. One
whole group then warms the window's shape. The window cycles through the
pool; each call copies its group to the device, as a loader's batches
would come.

The check runs the plain reference (``benchmark/reference/osnet.py``,
``softmax_train.py``) from the same weights, batches and flip draws (a
generator seeded as the engine's) for three steps, then the third
step's gradient again from the program's parameters before it, and
compares. The third step is a replay of the graph, so a step count that
a replay leaves frozen at the capture's (2) scales its update by
sqrt(1 - b2^t) / (1 - b1^t) of step 2, about 15 % more than step 3's:
``update3_median_leaf`` reads that.

On the card the cell measures the train graph, so set-up ends the run
with an error, before any step, where the engine would take eager steps
(``require_graph``): a program that cannot capture the optimizer's step
cannot run this cell.
"""
import gc
import statistics
import time
import types

import torch

from benchmark import compare
from benchmark.reference import softmax_train as ref_train
from benchmark.reference.layers import precision
from benchmark.traffic import train as train_kind
from benchmark.weights import make_weights

__all__ = ['Traffic', 'KEYS', 'TRAINS', 'TRAIN_CONTROL', 'FROZEN_AT',
           'make_batches', 'port_config', 'build_engine', 'require_graph',
           'calibration_readings']

TRAINS = True
# the control's precision: float8 (e4m3 operands, e5m2 output gradients,
# per-tensor scales), as the train kind's
TRAIN_CONTROL = 'fp8'
KEYS = ('image', 'pid')
CHECKED_STEPS = 3
# the step count a faulty graph would freeze: the capture's
FROZEN_AT = 2
# the identity head: the classifier's weight and the fc's batch-norm scale
HEADS = ('classifier.weight', 'fc.1.weight')


def make_batches(seed, n_batches, workload, config, device):
    """``(images uint8 [n, B, H, W, 3], pids int64 [n, B])`` on
    ``device``: ``ids`` identities a batch drawn from the configuration's
    classes, ``instances`` crops each, a crop its identity's random
    template plus noise of +-20 levels (``benchmark/data.py``'s draws,
    without the fields)."""
    m = config['model']
    ids, inst = workload['ids'], workload['instances']
    h, w = m['height'], m['width']
    g = torch.Generator(device=device).manual_seed(int(seed))
    pids = torch.stack([torch.randperm(m['num_classes'], generator=g,
                                       device=device)[:ids]
                        for _ in range(n_batches)])
    pids = pids.repeat_interleave(inst, dim=1)
    base = torch.randint(0, 256, (n_batches, ids, h, w, 3), generator=g,
                         device=device, dtype=torch.int16)
    noise = torch.randint(-20, 21, (n_batches, ids * inst, h, w, 3),
                          generator=g, device=device, dtype=torch.int16)
    images = (base.repeat_interleave(inst, dim=1) + noise).clamp_(0, 255) \
        .to(torch.uint8)
    return images, pids


def port_config(config, workload, seed):
    """The port's ``Config`` for the configuration: model, crop size,
    transforms, loss and optimizer, then the workload's ``port``
    overrides."""
    from bpbreid_tpu_torch.config import get_default_config
    m, loss, opt = config['model'], config['loss'], config['optim']
    if loss['eps'] != 0.1:
        raise ValueError('the port smooths labels by 0.1, the configuration '
                         'states {}'.format(loss['eps']))
    cfg = get_default_config()
    cfg.merge_from_dict({
        'model': {'name': m['name'], 'pretrained': False,
                  'compute_dtype': m['compute_dtype']},
        'data': {'height': m['height'], 'width': m['width'],
                 'transforms': list(config['transforms'])},
        'loss': {'name': loss['name'],
                 'softmax': {'label_smooth': loss['label_smooth']}},
        'train': {'optim': opt['name'], 'lr': opt['lr'],
                  'weight_decay': opt['weight_decay'], 'seed': int(seed)},
        'adam': {'beta1': opt['betas'][0], 'beta2': opt['betas'][1]},
    })
    cfg.merge_from_dict(workload.get('port', {}))
    return cfg


def build_engine(config, workload, seed, weights, device):
    """``(engine, model)``: the port's model with ``weights`` loaded
    (strict), its optimizer and its ``ImageSoftmaxEngine`` on
    ``device``."""
    from bpbreid_tpu_torch.config import optimizer_kwargs
    from bpbreid_tpu_torch.engine.image.softmax import ImageSoftmaxEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.optim import build_optimizer
    cfg = port_config(config, workload, seed)
    model = build_model(cfg.model.name, config['model']['num_classes'],
                        loss=cfg.loss.name, config=cfg, device=device,
                        seed=int(seed))
    model.load_state_dict(weights, strict=True)
    optimizer = build_optimizer(model, **optimizer_kwargs(cfg))
    data = types.SimpleNamespace(transforms=tuple(cfg.data.transforms),
                                 norm_mean=tuple(cfg.data.norm_mean),
                                 norm_std=tuple(cfg.data.norm_std))
    engine = ImageSoftmaxEngine(
        data, model, optimizer,
        label_smooth=cfg.loss.softmax.label_smooth, config=cfg,
        device=device)
    return engine, model


def require_graph(engine, device):
    """Raises where ``engine`` on a CUDA ``device`` would not replay the
    train step's CUDA graph (``Engine.train_graphs``): the cell is its
    groups back to back through that graph, and eager steps of the same
    recipe are another path, bound by the host."""
    if torch.device(device).type == 'cuda' and not engine.train_graphs:
        raise RuntimeError(
            'the cell runs the train graph, and this engine takes eager '
            'steps with {}: the program cannot capture its step'.format(
                type(engine.optimizer).__name__))


class Traffic(train_kind.Traffic):
    """The train kind's pool, window, traced stretch, release and check
    (``benchmark/traffic/train.py``), with this kind's batches, engine,
    readings and reference."""

    def _batch(self, i):
        """Batch ``i`` of the pool as a group of one step."""
        g, j = divmod(i, self.k)
        return {key: self.pool[g][key][j:j + 1] for key in KEYS}

    def setup(self):
        ctx, dev = self.ctx, self.ctx.device
        cuda = torch.device(dev).type == 'cuda'
        n = self.k * int(self.workload['pool_groups'])
        if n < CHECKED_STEPS:
            raise ValueError('the pool holds {} batches; the check needs {}'
                             .format(n, CHECKED_STEPS))
        images, pids = make_batches(ctx.seed + 1, n, self.workload,
                                    self.config, dev)
        self.pool = []
        for g in range(0, n, self.k):
            group = {}
            for key, t in zip(KEYS, (images, pids)):
                host = t[g:g + self.k].cpu()
                group[key] = host.pin_memory() if cuda else host
            self.pool.append(group)
        del images, pids
        weights = make_weights(self.ref.state_shapes(self.config), ctx.seed,
                               dev, self.ref)
        self.host_weights = {k: v.cpu() for k, v in weights.items()}
        self.engine, self.model = build_engine(
            self.config, self.workload, self.engine_seed, weights, dev)
        require_graph(self.engine, dev)
        opt = self.engine.optimizer
        names = [n for n, _ in self.model.named_parameters()]
        params = [p for _, p in self.model.named_parameters()]
        b1 = opt.param_groups[0]['b1']
        heads = [i for i, n in enumerate(names) if n in HEADS]

        def moments(indices):
            # amsgrad's first moment; a step that left no state took no
            # gradient
            return [opt.state[params[j]]['mu'].detach().clone()
                    if 'mu' in opt.state.get(params[j], {})
                    else torch.zeros_like(params[j]) for j in indices]
        moment = [torch.zeros_like(params[i]) for i in heads]
        self.prog_losses, self.prog_heads = [], []
        for i in range(CHECKED_STEPS):
            if i == CHECKED_STEPS - 1:
                # the state the last checked step (a replay) starts from
                self.prog_state = {
                    n: t.detach().to('cpu', torch.float32, copy=True)
                    for n, t in self.model.state_dict().items()}
            losses, _summary = self.engine.forward_backward_multi(
                self._batch(i))
            self.prog_losses.append(float(losses[0]))
            # the step's gradient as amsgrad took it: mu_t = b1 mu_{t-1}
            # + (1 - b1) g_t; steps 2 and 3 are replays of the train graph
            now = moments(heads)
            self.prog_heads.append({names[j]: ((m - b1 * m0) / (1 - b1))
                                    .float().cpu()
                                    for j, m, m0 in zip(heads, now, moment)})
            moment = now
            if i == 0:
                self.prog_grad = dict(zip(names, compare.norms(
                    [m / (1 - b1) for m in moments(range(len(params)))])))
        self.prog_update = dict(zip(names, compare.norms(
            [p.detach() - weights[n] for n, p in zip(names, params)])))
        self.prog_update3 = dict(zip(names, compare.norms(
            [p.detach() - self.prog_state[n].to(p.device)
             for n, p in zip(names, params)])))
        del weights, moment, now
        self.engine.forward_backward_multi(self.pool[0])
        self._sync()

    def reference(self, mode='f32', rows=None, frozen_at=None):
        """The reference's three steps in precision ``mode`` (on the
        first ``rows`` crops of each batch when given; with the step
        count frozen at ``frozen_at`` when given): losses, the first
        gradients as the update took them, the loss gradients' norms, the
        parameters' change and the third step's change, by leaf, the
        identity head's gradients of each step as the update took them
        (``heads``), and those of the last step taken again from the
        state the program's last step started from (``heads_replay``)."""
        dev, config = self.ctx.device, self.config
        o = config['optim']
        gen = torch.Generator(device=dev).manual_seed(self.engine_seed)
        steps = []
        for i in range(CHECKED_STEPS):
            images, pids = (self._batch(i)[key][0].to(dev) for key in KEYS)
            d = ref_train.draws(gen, images.shape[0], config['transforms'])
            if rows is not None:
                images, pids = images[:rows], pids[:rows]
                d = {k: None if v is None else v[:rows]
                     for k, v in d.items()}
            steps.append((images, pids, d))

        def optimizer(model):
            return ref_train.AMSGrad(model.parameters(), o['lr'],
                                     o['weight_decay'], tuple(o['betas']),
                                     frozen_at=frozen_at)
        eps = config['loss']['eps']
        with precision(mode):
            model = self.ref.build(config, dev)
            model.load_state_dict(self.host_weights, strict=True)
            names = [n for n, _ in model.named_parameters()]
            p0 = [p.detach().clone() for p in model.parameters()]
            opt = optimizer(model)
            losses, heads = [], []
            for i, step in enumerate(steps):
                if i == CHECKED_STEPS - 1:
                    before = [p.detach().clone() for p in model.parameters()]
                loss, grads, taken = ref_train.train_step(model, opt, *step,
                                                          eps=eps)
                losses.append(loss)
                heads.append(self._heads(names, taken))
                if i == 0:
                    grad = dict(zip(names, compare.norms(taken)))
                    loss_grad = dict(zip(names, compare.norms(
                        [torch.zeros((), device=dev) if g is None else g
                         for g in grads])))
            update = dict(zip(names, compare.norms(
                [p.detach() - q for p, q in zip(model.parameters(), p0)])))
            update3 = dict(zip(names, compare.norms(
                [p.detach() - q for p, q in zip(model.parameters(),
                                                before)])))
            del opt, p0, before
            # the last step again, from the program's own state: the
            # replayed step's forward and backward, without the steps
            # before it (their updates are compared above)
            model.load_state_dict(self.prog_state, strict=True)
            opt = optimizer(model)
            taken = ref_train.train_step(model, opt, *steps[-1], eps=eps)[2]
            heads_replay = self._heads(names, taken)
        del model, opt, steps
        return {'losses': losses, 'grad': grad, 'loss_grad': loss_grad,
                'update': update, 'update3': update3, 'heads': heads,
                'heads_replay': heads_replay}

    @staticmethod
    def _heads(names, tensors):
        return {n: t.detach().float().cpu() for n, t in zip(names, tensors)
                if n in HEADS}

    @staticmethod
    def readings(prog, ref):
        """Every candidate number of the comparison, from the program's
        readings ``prog`` (``losses``, ``grad``, ``heads``,
        ``heads_replay``, ``update``, ``update3``) and the reference's
        ``ref``."""
        out = {'loss_step{}'.format(i + 1): compare.relative_gap(p, r)
               for i, (p, r) in enumerate(zip(prog['losses'],
                                              ref['losses']))}
        # leaves whose loss gradient is near rounding (the fc's linear
        # bias ahead of its batch norm) are left out of the changes
        med = statistics.median(ref['loss_grad'].values())
        keep = {n for n, v in ref['loss_grad'].items() if v >= 1e-3 * med}
        for key, kept in (('grad', None), ('update', keep),
                          ('update3', keep)):
            gaps = compare.leaf_gaps(prog[key], ref[key], kept)
            out[key + '_worst_leaf'] = max(gaps.values())
            out[key + '_median_leaf'] = statistics.median(gaps.values())

        # the identity head's gradient of each step by the norm of its
        # difference: the gap of norms sees an unbiased rounding (a turn of
        # the gradient) only at second order
        def heads(p, r):
            return max(compare.difference_gap(p[n], r[n])
                       for n in r if n in keep)
        for i, (p, r) in enumerate(zip(prog['heads'], ref['heads'])):
            out['head_grad_step{}'.format(i + 1)] = heads(p, r)
        out['head_grad_replay'] = heads(prog['heads_replay'],
                                        ref['heads_replay'])
        out['leaves_left_out'] = len(ref['update']) - len(keep)
        return out

    def program_readings(self):
        return {'losses': self.prog_losses, 'grad': self.prog_grad,
                'heads': self.prog_heads, 'heads_replay': self.prog_heads[-1],
                'update': self.prog_update, 'update3': self.prog_update3}


def calibration_readings(ctx_for, seed, controls, seconds):
    """``[(what, readings, extra)]`` for ``benchmark/calibrate.py``: the
    sound run's (set-up only; no window), and with ``controls`` the float8
    reference's in the program's place (``control``), the reference on
    half of each batch (``fault_half_batch``) and the reference with its
    step count frozen at the capture's (``fault_frozen_step``)."""
    del seconds
    tr = ctx_for(seed)
    t0 = time.perf_counter()
    tr.setup()
    setup_s = time.perf_counter() - t0
    tr.release()
    ref = tr.reference('f32')
    rows = [('sound', tr.readings(tr.program_readings(), ref),
             {'setup_s': setup_s, 'losses': tr.prog_losses,
              'ref_losses': ref['losses']})]
    if controls:
        low = tr.reference(TRAIN_CONTROL)
        rows.append(('control', tr.readings(low, ref),
                     {'losses': low['losses'], 'precision': TRAIN_CONTROL}))
        n = int(tr.pool[0]['pid'].shape[1])
        half = tr.reference('f32', rows=n // 2)
        rows.append(('fault_half_batch', tr.readings(half, ref),
                     {'losses': half['losses']}))
        frozen = tr.reference('f32', frozen_at=FROZEN_AT)
        rows.append(('fault_frozen_step', tr.readings(frozen, ref),
                     {'losses': frozen['losses']}))
    del tr
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return rows
