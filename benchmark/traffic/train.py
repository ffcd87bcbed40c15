"""Traffic kind ``train``: the part-based engine's
``forward_backward_multi`` on groups of ``steps_per_dispatch`` steps, back
to back (a closed loop), through the train step's CUDA graph on the card.

Set-up makes a pool of ``pool_groups`` groups of distinct seeded batches
(``ids`` x ``instances`` crops and their fields) and keeps it pinned on
the host, makes the weights, builds the engine with them, and runs the
first three steps through the window's own call
(``forward_backward_multi``, one step a call, on the pool's first three
batches): the first runs eagerly, the second captures the graph, the
third replays it. Their losses and the first loss's terms, the first
gradient (from Adam's first moment after step 1), the identity heads'
gradient of each step (from the first moment's change over the step) and
the parameters' change after step 3 are read as the program left them. One whole group
then warms the window's shape. The window cycles through the pool; each
call copies its group to the device, as a loader's batches would come.

The check runs the plain reference from the same weights, batches and
augmentation draws (a generator seeded as the engine's) for three steps,
then the third step again from the program's parameters before it, and
compares.
"""
import gc
import statistics
import time

import torch

from benchmark import compare, data
from benchmark.port import build_engine
from benchmark.reference import reference_of
from benchmark.reference import train as ref_train
from benchmark.reference.layers import precision
from benchmark.weights import make_weights

__all__ = ['Traffic', 'KEYS', 'TRAINS', 'TRAIN_CONTROL',
           'calibration_readings']

TRAINS = True
# the control's precision: float8 (e4m3 operands, e5m2 output gradients,
# per-tensor scales); int8 separated less from the program's bf16 on the
# identity heads' gradients (see PERF.md)
TRAIN_CONTROL = 'fp8'
KEYS = ('image', 'mask', 'pid')
CHECKED_STEPS = 3
HEADS = ('identity_classifier.classifier.weight',
         'identity_classifier.bn.weight')


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.workload = ctx.cell.config, ctx.cell.workload
        self.k = int(self.workload['steps_per_dispatch'])
        self.engine = self.model = None
        # the leaf of the largest gap, by number, of the last readings
        self.worst_leaves = {}

    @property
    def ref(self):
        """The configuration's plain reference module."""
        return reference_of(self.config, self.ctx.cell.root)

    def _sync(self):
        if torch.device(self.ctx.device).type == 'cuda':
            torch.cuda.synchronize(self.ctx.device)

    def _group(self, i):
        return self.pool[i % len(self.pool)]

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
        images, fields, pids = data.make_batches(ctx.seed + 1, n,
                                                 self.workload, self.config,
                                                 dev)
        self.pool = []
        for g in range(0, n, self.k):
            group = {}
            for key, t in zip(KEYS, (images, fields, pids)):
                host = t[g:g + self.k].cpu()
                group[key] = host.pin_memory() if cuda else host
            self.pool.append(group)
        del images, fields, pids
        weights = make_weights(self.ref.state_shapes(self.config), ctx.seed,
                               dev, self.ref)
        self.host_weights = {k: v.cpu() for k, v in weights.items()}
        self.engine, self.model = build_engine(
            self.config, self.workload, self.engine_seed, weights, dev,
            train=True)
        opt = self.engine.optimizer
        names = [n for n, _ in self.model.named_parameters()]
        params = [p for _, p in self.model.named_parameters()]
        b1 = opt.param_groups[0]['betas'][0]
        heads = [i for i, n in enumerate(names) if n.endswith(HEADS)]
        moment = [torch.zeros_like(params[i]) for i in heads]
        self.prog_losses, self.prog_heads = [], []
        for i in range(CHECKED_STEPS):
            if i == CHECKED_STEPS - 1:
                # the state the last checked step (a replay) starts from
                self.prog_state = dict(self.host_weights)
                self.prog_state.update(
                    (n, p.detach().to('cpu', torch.float32, copy=True))
                    for n, p in zip(names, params))
            losses, summary = self.engine.forward_backward_multi(
                self._batch(i))
            self.prog_losses.append(float(losses[0]))
            # the step's gradient as Adam took it: m_t = b1 m_{t-1} +
            # (1 - b1) g_t; steps 2 and 3 are replays of the train graph
            now = [opt.state[params[j]]['exp_avg'].detach().clone()
                   if 'exp_avg' in opt.state.get(params[j], {})
                   else torch.zeros_like(params[j]) for j in heads]
            self.prog_heads.append({names[j]: ((m - b1 * m0) / (1 - b1))
                                    .float().cpu()
                                    for j, m, m0 in zip(heads, now, moment)})
            moment = now
            if i == 0:
                self.prog_terms = self._terms(summary)
                # a step that left no state took no gradient
                self.prog_grad = dict(zip(names, compare.norms(
                    [opt.state[p]['exp_avg'] / (1 - b1)
                     if 'exp_avg' in opt.state.get(p, {})
                     else torch.zeros_like(p) for p in params])))
        self.prog_update = dict(zip(names, compare.norms(
            [p.detach() - weights[n] for n, p in zip(names, params)])))
        del weights, moment, now
        self.engine.forward_backward_multi(self.pool[0])
        self._sync()

    def _terms(self, summary):
        """The weighted ``id``, ``triplet`` and ``pixel`` terms of the first
        step's loss from the engine's summary (``[k]`` leaves)."""
        w = self.config['loss']['weights']

        def first(t):
            return float(t[0].detach())
        terms = {'id': 0.0, 'triplet': 0.0}
        for key in ('globl', 'foreg', 'conct', 'parts'):
            if w[key]['id'] > 0:
                terms['id'] += w[key]['id'] * first(summary[key]['c'])
            if w[key]['tr'] > 0:
                terms['triplet'] += w[key]['tr'] * first(summary[key]['t'])
        terms['pixel'] = w['pixls']['ce'] * first(summary['pixls']['c'])
        return terms

    @property
    def engine_seed(self):
        return self.ctx.seed + 2

    def window(self, seconds):
        self._sync()
        t0 = time.perf_counter()
        groups = 0
        while True:
            self.engine.forward_backward_multi(self._group(groups))
            groups += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        dt = time.perf_counter() - t0
        steps = groups * self.k
        images = steps * int(self.pool[0]['pid'].shape[1])
        return {'attempted': steps, 'steps': steps, 'images': images,
                'seconds': dt,
                'metrics': {'train_images_per_s': images / dt}}

    def traced(self):
        from benchmark.trace import profile
        groups = int(self.workload.get('traced_groups', 1))
        return profile(lambda: [self.engine.forward_backward_multi(
            self._group(i)) for i in range(groups)], groups * self.k,
            self.ctx.device)

    def release(self):
        self.engine = self.model = None
        gc.collect()
        if torch.device(self.ctx.device).type == 'cuda':
            torch.cuda.empty_cache()

    def reference(self, mode='f32', rows=None):
        """The reference's three steps in precision ``mode`` (on the
        first ``rows`` crops of each batch when given): losses, the first
        gradients as the update took them, the loss gradients' norms and
        the parameters' change, by leaf, the identity heads' gradients of
        each step as the update took them (``heads``), and those of the
        last step taken again from the state the program's last step
        started from (``heads_replay``)."""
        dev, config = self.ctx.device, self.config
        m = config['model']
        gen = torch.Generator(device=dev).manual_seed(self.engine_seed)
        steps = []
        for i in range(CHECKED_STEPS):
            images, fields, pids = (t[0].to(dev) for t in (
                self._batch(i)[key] for key in KEYS))
            d = ref_train.draws(gen, images.shape[0], m['height'],
                                m['width'], config['transforms'])
            if rows is not None:
                images, fields, pids = images[:rows], fields[:rows], \
                    pids[:rows]
                d = {'off': d['off'][:rows], 'erase': tuple(
                    t[:rows] for t in d['erase'])}
            steps.append((images, fields, pids, d))
        o = config['optim']
        with precision(mode):
            model = self.ref.build(config, dev)
            model.load_state_dict(self.host_weights, strict=True)
            names = [n for n, _ in model.named_parameters()]
            p0 = [p.detach().clone() for p in model.parameters()]
            opt = ref_train.Adam(model.parameters(), o['lr'],
                                 o['weight_decay'], tuple(o['betas']))
            losses, heads = [], []
            for i, step in enumerate(steps):
                loss, terms, grads, taken = ref_train.train_step(
                    model, opt, *step, config)
                losses.append(loss)
                heads.append(self._heads(names, taken))
                if i == 0:
                    first_terms = terms
                    grad = dict(zip(names, compare.norms(taken)))
                    loss_grad = dict(zip(names, compare.norms(
                        [torch.zeros((), device=dev) if g is None else g
                         for g in grads])))
            update = dict(zip(names, compare.norms(
                [p.detach() - q for p, q in zip(model.parameters(), p0)])))
            del opt, p0
            # the last step again, from the program's own state: the
            # replayed step's forward and backward, without the steps
            # before it (their updates are compared above)
            model.load_state_dict(self.prog_state, strict=True)
            opt = ref_train.Adam(model.parameters(), o['lr'],
                                 o['weight_decay'], tuple(o['betas']))
            taken = ref_train.train_step(model, opt, *steps[-1], config)[3]
            heads_replay = self._heads(names, taken)
        del model, opt, steps
        return {'losses': losses, 'grad': grad, 'loss_grad': loss_grad,
                'update': update, 'terms': first_terms, 'heads': heads,
                'heads_replay': heads_replay}

    @staticmethod
    def _heads(names, tensors):
        return {n: t.detach().float().cpu() for n, t in zip(names, tensors)
                if n.endswith(HEADS)}

    def readings(self, prog, ref):
        """Every candidate number of the comparison, from the program's
        readings ``prog`` (``losses``, ``terms``, ``grad``, ``heads``,
        ``heads_replay``, ``update``) and the reference's ``ref``."""
        out = {'loss_step{}'.format(i + 1): compare.relative_gap(p, r)
               for i, (p, r) in enumerate(zip(prog['losses'],
                                              ref['losses']))}
        med = statistics.median(ref['loss_grad'].values())
        keep = {n for n, v in ref['loss_grad'].items() if v >= 1e-3 * med}
        for key, kept in (('grad', None), ('update', keep)):
            gaps = compare.leaf_gaps(prog[key], ref[key], kept)
            out[key + '_worst_leaf'] = max(gaps.values())
            out[key + '_median_leaf'] = statistics.median(gaps.values())
            # the identity heads' leaves, whose gradient the smooth
            # identity losses give directly, with no backward through the
            # triplets' hard mining
            out[key + '_worst_head'] = max(
                g for n, g in gaps.items() if n.endswith(HEADS))
            self.worst_leaves[key] = max(gaps, key=gaps.get)
        # the identity heads' gradient of each step by the norm of its
        # difference: the gap of norms sees an unbiased rounding (a turn of
        # the gradient) only at second order
        def heads(p, r):
            return max(compare.difference_gap(p[n], r[n])
                       for n in r if n in keep)
        for i, (p, r) in enumerate(zip(prog['heads'], ref['heads'])):
            out['head_grad_step{}'.format(i + 1)] = heads(p, r)
        out['head_grad_replay'] = heads(prog['heads_replay'],
                                        ref['heads_replay'])
        for term, value in prog['terms'].items():
            out[term + '_step1'] = compare.relative_gap(value,
                                                        ref['terms'][term])
        out['leaves_left_out'] = len(ref['update']) - len(keep)
        return out

    def program_readings(self):
        return {'losses': self.prog_losses, 'terms': self.prog_terms,
                'grad': self.prog_grad, 'heads': self.prog_heads,
                'heads_replay': self.prog_heads[-1],
                'update': self.prog_update}

    def check(self):
        readings = self.readings(self.program_readings(), self.reference())
        return {name: compare.check(readings[name], limit)
                for name, limit in self.workload['limits'].items()}


def calibration_readings(ctx_for, seed, controls, seconds):
    """``[(what, readings, extra)]`` for ``benchmark/calibrate.py``: the
    sound run's (set-up only; no window), and with ``controls`` the float8
    reference's in the program's place (``control``) and the reference on
    half of each batch (``fault_half_batch``)."""
    tr = ctx_for(seed)
    t0 = time.perf_counter()
    tr.setup()
    setup_s = time.perf_counter() - t0
    tr.release()
    ref = tr.reference('f32')
    rows = [('sound', tr.readings(tr.program_readings(), ref),
             {'setup_s': setup_s, 'losses': tr.prog_losses,
              'ref_losses': ref['losses'],
              'worst_leaves': dict(tr.worst_leaves)})]
    if controls:
        low = tr.reference(TRAIN_CONTROL)
        rows.append(('control', tr.readings(low, ref),
                     {'losses': low['losses'], 'precision': TRAIN_CONTROL}))
        n = int(tr.pool[0]['pid'].shape[1])
        half = tr.reference('f32', rows=n // 2)
        rows.append(('fault_half_batch', tr.readings(half, ref),
                     {'losses': half['losses']}))
    del tr
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return rows
