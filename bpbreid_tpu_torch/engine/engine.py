"""Engine base: the train/test loop (port of bpbreid_tpu/engine/engine.py).

``run()`` drives epochs -> train -> periodic and final test ->
checkpoint, with the frozen-base epochs of two-stepped transfer learning
(``fixbase_epoch``, ``open_layers``), resume (``start_epoch``) and
graceful preemption: SIGTERM or SIGINT stops training at the next batch,
writes an emergency checkpoint and returns zeros.

Grouped dispatch, as in JAX: ``train`` stacks ``train.steps_per_dispatch``
consecutive batches into one ``[k, B, ...]`` group
(``group_train_batches``; a trailing partial group runs as single steps)
and runs it through ``forward_backward_multi``; the engines group their
eval batches by ``test.batches_per_dispatch``
(``_eval_batch_groups``). On a CUDA device without a mesh the k steps
(or batches) replay a captured CUDA graph of the step
(``engine/graphs.py``) with no host sync in between, where JAX scans
them in one compiled program; on the CPU, under a mesh (gloo cannot be
captured) or with an optimizer whose step reads the host (an Adam
built without ``capturable``; ``build_optimizer`` builds it so over CUDA
parameters) they run as k eager steps. The choice is made from the
configuration alone (``train_graphs``); a capture that fails raises.

``device_prefetch`` moves the next batches (or groups) to the device
while the current step computes.

Under a profiler the host's phases are spans of its trace
(``utils/tracing.py``): ``engine.forward_backward_multi`` (the whole
call) holding ``engine.train_inputs`` (the group's copy to the device)
and the ``graph.*`` spans of each step (``engine/graphs.py``);
``engine.backward`` and ``engine.optimizer`` in ``optimizer_step``; and
``prefetch.wait``, the consumer's wait for each prefetched batch. The
profiler keeps no op or span of the prefetch's worker thread, only its
CUDA API calls, so its pinning shows through this wait. PERF.md,
section 3, names the metric that reads each span.

Under ``parallel.distribute_engine`` (``mesh`` set: one rank of a
data-parallel run) every rank runs the same loop on the global batches;
``optimizer_step`` sums the gradients over the ranks, and rank 0 alone
writes checkpoints, scalars and figures (``writes``), as JAX's single
process writes them once.
"""
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bpbreid_tpu_torch.engine.graphs import GraphStep, tensor_addresses
from bpbreid_tpu_torch.optim.optimizer import is_capturable
from bpbreid_tpu_torch.parallel.mesh import all_reduce_flat, shard_bounds
from bpbreid_tpu_torch.utils.avgmeter import MetricsSummary, TimeMeter
from bpbreid_tpu_torch.utils.checkpoint import save_checkpoint
from bpbreid_tpu_torch.utils.engine_state import EngineState
from bpbreid_tpu_torch.utils.tracing import span

__all__ = ['Engine', 'device_prefetch', 'group_train_batches',
           'normalize', 'stack_steps', 'valid_rows']

DEVICE_KEYS = ('image', 'mask', 'pid')
# batches copied ahead of the one the step reads
PREFETCH_DEPTH = 2


def normalize(features, dim=-1):
    """L2-normalize along ``dim`` in f32 (JAX ``Engine.normalize``
    :352)."""
    f = features.float()
    return f / f.norm(dim=dim, keepdim=True).clamp(min=1e-12)


def group_train_batches(loader, k, keys=DEVICE_KEYS):
    """Stack ``k`` consecutive train batches into one ``[k, B, ...]``
    group for ``forward_backward_multi`` (JAX ``group_train_batches``
    :23): yields the stacked ``keys`` with ``_k`` = k for each full group,
    then the batches of a trailing partial group as they are (no
    ``_k``), which run as single steps."""
    buf = []
    for batch in loader:
        buf.append(batch)
        if len(buf) == k:
            stacked = {key: np.stack([np.asarray(b[key]) for b in buf])
                       for key in keys if buf[0].get(key) is not None}
            stacked['_k'] = k
            yield stacked
            buf = []
    yield from buf


def stack_steps(outputs):
    """``[(loss, summary)]`` of k steps -> ``(losses [k], summary with
    [k] leaves)``, on the device."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {key: stack([t[key] for t in trees]) for key in trees[0]}
        return torch.stack(trees)
    return stack([loss for loss, _ in outputs]), stack(
        [summary for _, summary in outputs])


def valid_rows(t, valid):
    """The rows of ``t`` where the host's bool ``valid`` is True, taken by
    an index tensor (no readback); ``t`` itself when all are."""
    if valid.all():
        return t
    rows = torch.as_tensor(np.flatnonzero(valid)).to(t.device,
                                                      non_blocking=True)
    return t.index_select(0, rows)


def _last_step(summary):
    """The last step's terms of a summary with ``[k]`` leaves."""
    if isinstance(summary, dict):
        return {key: _last_step(v) for key, v in summary.items()}
    return summary[-1]


def device_prefetch(loader, device, keys=DEVICE_KEYS):
    """Yield the batches of ``loader`` with ``keys`` as tensors on
    ``device``; the other fields (camid, valid, index) stay numpy.

    On a CUDA device a worker thread pins each batch's arrays and copies
    them on a side stream, up to ``PREFETCH_DEPTH`` batches ahead of the
    consumer.
    Before a batch is handed over, the consumer's current stream waits for
    its copy (an event), and each tensor is marked as used on that stream
    (``record_stream``), so the allocator does not reuse its memory while
    the step still reads it. On the CPU the batches pass through with
    ``keys`` as tensors.
    """
    device = torch.device(device)
    if device.type != 'cuda':
        for batch in loader:
            with span('prefetch.wait'):
                out = dict(batch)
                for k in keys:
                    if out.get(k) is not None:
                        out[k] = torch.as_tensor(out[k])
            yield out
        return
    copy_stream = torch.cuda.Stream(device)

    def to_device(batch):
        out = dict(batch)
        with torch.cuda.stream(copy_stream):
            for k in keys:
                v = out.get(k)
                if v is None:
                    continue
                t = torch.as_tensor(v)
                if t.device.type == 'cpu':
                    t = t.pin_memory().to(device, non_blocking=True)
                out[k] = t
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def hand_over(future):
        with span('prefetch.wait'):
            out, done = future.result()
            compute = torch.cuda.current_stream(device)
            compute.wait_event(done)
            for k in keys:
                if isinstance(out.get(k), torch.Tensor):
                    out[k].record_stream(compute)
        return out

    # one worker: the copies stay in batch order
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = deque()
        for batch in loader:
            pending.append(pool.submit(to_device, batch))
            if len(pending) > PREFETCH_DEPTH:
                yield hand_over(pending.popleft())
        while pending:
            yield hand_over(pending.popleft())


class Engine:
    """The host control flow of training and testing; subclasses supply
    ``train_inputs`` and ``train_step`` (through ``optimizer_step``),
    ``forward_backward`` and ``_evaluate``, and set ``model``,
    ``optimizer``, ``scheduler``, ``open_layers``, ``save_model_flag``,
    ``device`` and ``generator``."""

    @staticmethod
    def _eval_batch_groups(loader, k):
        """Lists of ``k`` consecutive eval batches
        (``test.batches_per_dispatch``; JAX :77). A trailing short group
        is padded with copies of its last batch whose rows are all
        invalid (``valid`` False), so every group has k batches of one
        shape; the padding contributes nothing to the outputs."""
        buf = []
        for batch in loader:
            buf.append(batch)
            if len(buf) == k:
                yield buf
                buf = []
        if buf:
            filler = dict(buf[-1])
            filler['valid'] = np.zeros(len(np.asarray(buf[-1]['pid'])),
                                       bool)
            buf.extend([filler] * (k - len(buf)))
            yield buf

    def __init__(self, config=None, datamanager=None, writer=None,
                 engine_state=None):
        self.config = config
        self.datamanager = datamanager
        self.writer = writer
        start = config.train.start_epoch if config is not None else 0
        stop = config.train.max_epoch if config is not None else 0
        self.engine_state = engine_state or EngineState(start, stop)
        self.epoch = self.start_epoch = start
        self.max_epoch = stop
        self.scheduler = None
        self._preempted = False
        # what the shared train-step parts read; subclasses set them
        self.model = self.optimizer = None
        self.open_layers = []
        self._freeze_base = False
        self.save_model_flag = False
        # parallel.distribute_engine: this rank's Mesh
        self.mesh = None
        # the CUDA graphs of the train and eval steps (engine/graphs.py)
        self._train_graph = self._eval_graph = None

    @property
    def steps_per_dispatch(self):
        """k of the grouped train dispatch: ``train.steps_per_dispatch``
        (1 without a config, and with ``train.batch_debug_freq``, whose
        figures need each step's outputs)."""
        tcfg = getattr(self.config, 'train', None)
        if tcfg is None or getattr(tcfg, 'batch_debug_freq', 0):
            return 1
        return max(1, int(getattr(tcfg, 'steps_per_dispatch', 1) or 1))

    @property
    def batches_per_dispatch(self):
        """k of the grouped eval dispatch: ``test.batches_per_dispatch``
        (1 without a config)."""
        tcfg = getattr(self.config, 'test', None)
        if tcfg is None:
            return 1
        return max(1, int(getattr(tcfg, 'batches_per_dispatch', 1) or 1))

    @property
    def eval_graphs(self):
        """Whether grouped eval batches replay a CUDA graph: on a CUDA
        device without a mesh."""
        return torch.device(self.device).type == 'cuda' and self.mesh is None

    @property
    def train_graphs(self):
        """Whether ``forward_backward_multi`` replays a CUDA graph of the
        train step: on a CUDA device, without a mesh (gloo cannot be
        captured), with an optimizer whose step reads nothing on the
        host (``optim.is_capturable``): SGD, the ``OptaxRule`` optimizers
        (amsgrad, rmsprop, radam), whose step counts live on the device,
        or Adam built with ``capturable=True`` (``optim.build_optimizer``
        builds it so on a CUDA device). An Adam without ``capturable``
        keeps its step count on the host, where a graph would freeze it,
        so it takes k eager steps."""
        return self.eval_graphs and is_capturable(self.optimizer)

    def _train_state(self):
        """Where the tensors a train step reads and writes lie: the
        parameters, their gradients, the buffers and the optimizer's
        state, a group's own tensors (an ``OptaxRule``'s step count on
        the device) included."""
        params = list(self.model.parameters())
        opt_state = [v for p in params
                     for v in self.optimizer.state.get(p, {}).values()
                     if isinstance(v, torch.Tensor)]
        opt_state += [v for g in self.optimizer.param_groups
                      for v in g.values() if isinstance(v, torch.Tensor)]
        return tensor_addresses(params + [p.grad for p in params]
                                + list(self.model.buffers()) + opt_state)

    def _eval_state(self):
        """Where the parameters and buffers an eval step reads lie, and
        their versions (the int8 weight cache follows them)."""
        return tensor_addresses(list(self.model.parameters())
                                + list(self.model.buffers()), versions=True)

    def _eval_batches(self, loader, step, keys=('image',), key=()):
        """``(batch, step(*inputs))`` for each batch of ``loader`` with a
        valid row (``valid`` filled in when missing), ``inputs`` the
        batch's ``keys`` on the device (None where missing). With
        ``batches_per_dispatch`` k above 1 the batches come in groups of
        k (``_eval_batch_groups``; the padding of a trailing group has no
        valid row and is skipped) and, with ``eval_graphs``, each replays
        the CUDA graph of ``step`` (``key`` keys it beside the inputs'
        shapes and the model's state), captured at the second batch."""
        k = self.batches_per_dispatch
        batches = loader
        if k > 1:
            batches = (b for group in self._eval_batch_groups(loader, k)
                       for b in group)
        graph = None
        if k > 1 and self.eval_graphs:
            if self._eval_graph is None or self._eval_graph.fn != step:
                self._eval_graph = GraphStep(step, state=self._eval_state)
            graph = self._eval_graph
        for batch in device_prefetch(batches, self.device, keys=keys):
            batch['valid'] = np.asarray(batch.get(
                'valid', np.ones(len(batch['pid']), bool)), bool)
            if not batch['valid'].any():
                continue
            inputs = [batch.get(name) for name in keys]
            yield batch, (graph(inputs, key) if graph is not None
                          else step(*inputs))

    def train_inputs(self, batch):
        """The train step's input tensors of ``batch`` on the device."""
        raise NotImplementedError

    def train_step(self, *inputs, draws=None):
        """One train step on the device tensors ``inputs``; returns
        ``(loss, summary)`` as tensors on the device."""
        raise NotImplementedError

    def forward_backward_multi(self, batch, draws=None):
        """``k = batch['image'].shape[0]`` train steps on the step-stacked
        ``[k, B, ...]`` arrays of ``batch`` (JAX ``forward_backward_multi``,
        part_based.py:262): through the train step's CUDA graph with
        ``train_graphs`` (k replays, no host sync in between), else k
        eager steps. ``draws`` (eager path only) is a list of k
        augmentation draws. Returns the ``[k]`` loss vector and the
        summary with ``[k]`` leaves, on the device."""
        with span('engine.forward_backward_multi'):
            self.require_optimizer()
            with span('engine.train_inputs'):
                inputs = self.train_inputs(batch)
            k = inputs[0].shape[0]
            steps = [[None if t is None else t[i] for t in inputs]
                     for i in range(k)]
            if not self.train_graphs:
                draws = draws if draws is not None else [None] * k
                return stack_steps([self.train_step(*s, draws=d)
                                    for s, d in zip(steps, draws)])
            if draws is not None:
                raise ValueError('draws are taken from the engine\'s '
                                 'generator on the CUDA graph path')
            if self._train_graph is None:
                self._train_graph = GraphStep(
                    self.train_step, generators=self.step_generators(),
                    state=self._train_state)
            key = (tuple(g['lr'] for g in self.optimizer.param_groups),
                   self._freeze_base)
            out = stack_steps([self._train_graph(s, key) for s in steps])
            # the replays wrote the parameters and buffers in place: their
            # version counters move as an eager step's would (caches such
            # as the int8 weights' key on them)
            for t in (list(self.model.parameters())
                      + list(self.model.buffers())):
                torch.autograd.graph.increment_version(t)
            return out

    def step_generators(self):
        """The generators the train step draws from: the engine's."""
        return [getattr(self, 'generator', None)]

    @property
    def writes(self):
        """Whether this process writes files (rank 0, or no mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def shard(self, n):
        """``(lo, hi)`` of this rank's rows of a global batch of ``n``
        (``(0, n)`` without a mesh)."""
        return (0, n) if self.mesh is None else shard_bounds(n, self.mesh)

    def _request_preemption(self, signum=None, frame=None):
        del frame
        print('=> Preemption signal{} received: will checkpoint and stop '
              'at the next batch boundary'.format(
                  ' {}'.format(signum) if signum is not None else ''))
        self._preempted = True

    def _install_preemption_handlers(self):
        """Returns a restore callback (a no-op outside the main thread)."""
        import signal
        prev = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev[sig] = signal.signal(sig, self._request_preemption)
        except ValueError:          # not the main thread
            return lambda: None

        def restore():
            for sig, handler in prev.items():
                signal.signal(sig, handler)
        return restore

    # ------------------------------------------------------------------
    # subclass contract
    # ------------------------------------------------------------------
    def forward_backward(self, batch):
        raise NotImplementedError

    def _evaluate(self, epoch, dataset_name='', query_loader=None,
                  gallery_loader=None, **kwargs):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # the train step's and the checkpoints' shared parts
    # ------------------------------------------------------------------
    def set_freeze_base(self, freeze):
        """Two-stepped transfer learning: while frozen, only parameters
        named by ``open_layers`` get their gradient; the others get zeros
        (the optimizer still applies weight decay to them, as the JAX
        step does)."""
        self._freeze_base = bool(freeze)

    def apply_lr(self, epoch):
        """Set the optimizer's learning rate for ``epoch``."""
        if self.scheduler is not None and self.optimizer is not None:
            self.scheduler.set_in_optimizer(self.optimizer, epoch)

    def require_optimizer(self):
        """Raise for a train step of an engine built without an
        optimizer."""
        if self.optimizer is None:
            raise RuntimeError('the engine has no optimizer: build it with '
                               'one to train')

    def optimizer_step(self, loss):
        """Backward of ``loss``, the frozen-base gradient mask, then the
        optimizer's step. A parameter with no path to the loss gets a zero
        gradient, as JAX gives, so the optimizer's weight decay and
        moments still apply to it. Under a mesh the gradients are first
        summed over the ranks (one flat ``all_reduce``): each rank's
        gradient flows through its own slice of the global batch only."""
        with span('engine.backward'):
            self.optimizer.zero_grad(set_to_none=False)
            loss.backward()
        with span('engine.optimizer'):
            params = list(self.model.named_parameters())
            for _name, p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self.mesh is not None:
                all_reduce_flat([p.grad for _name, p in params], self.mesh)
            if self._freeze_base:
                for name, p in params:
                    if not any(ol in name for ol in self.open_layers):
                        p.grad.zero_()
            self.optimizer.step()

    def save_model(self, epoch, save_dir, cmc=None, mAP=None, ssmd=None,
                   is_best=False, force=False):
        """Write a checkpoint (``utils/checkpoint.py``) when
        ``save_model_flag`` or ``force`` (preemption) is set, on rank 0
        under a mesh; returns its path or None."""
        if (not self.save_model_flag and not force) or not self.writes:
            return None
        meta = {'epoch': epoch,
                'rank1': float(cmc[0]) if cmc is not None else None,
                'mAP': float(mAP) if mAP is not None else None,
                'ssmd': float(ssmd) if ssmd is not None else None,
                'config': (self.config.to_dict()
                           if self.config is not None else None)}
        job_id = self.config.project.job_id if self.config is not None else 0
        return save_checkpoint(self.model, self.optimizer, meta, save_dir,
                               job_id=job_id, epoch=epoch, is_best=is_best)

    def update_lr(self, epoch):
        if self.scheduler is None:
            return None
        lr = self.scheduler(epoch)
        self.engine_state.update_lr(lr)
        self.apply_lr(epoch)
        return lr

    # ------------------------------------------------------------------
    def run(self, save_dir='log', max_epoch=0, start_epoch=0, print_freq=10,
            fixbase_epoch=0, open_layers=None, start_eval=0, eval_freq=-1,
            test_only=False, dist_metric='euclidean', normalize_feature=False,
            visrank=False, visrank_topk=10, visrank_q_idx_list=None,
            visrank_count=10, use_metric_cuhk03=False, ranks=(1, 5, 10, 20),
            rerank=False, save_features=False, **kwargs):
        """Train ``start_epoch .. max_epoch`` (the engine's own
        ``start_epoch``, set on resume) and test; or only test. Returns
        ``(cmc, mAP, ssmd, pixel_accuracy)`` of the last test. A training
        run ends with its elapsed time and, for each CUDA graph of the
        train and eval steps, its eager steps, captures and replays (a
        recapture at each new learning rate shows there)."""
        del start_epoch, kwargs
        if max_epoch:
            self.max_epoch = max_epoch
            self.engine_state.max_epoch = max_epoch
        test_kwargs = dict(dist_metric=dist_metric,
                           normalize_feature=normalize_feature,
                           save_dir=save_dir,
                           use_metric_cuhk03=use_metric_cuhk03, ranks=ranks)
        last_kwargs = dict(test_kwargs, visrank=visrank,
                           visrank_topk=visrank_topk,
                           visrank_q_idx_list=visrank_q_idx_list or [],
                           visrank_count=visrank_count, rerank=rerank,
                           save_features=save_features)
        self.engine_state.run_started()
        if test_only:
            result = self.test(self.epoch, **last_kwargs)
            self.engine_state.run_completed()
            return result

        print('=> Start training')
        if self.writer is not None:
            self.writer.total_run_timer.start()
        restore_signals = self._install_preemption_handlers()
        self.engine_state.training_started()
        time_start = time.time()
        best_rank1 = -1.0
        for epoch in range(self.start_epoch, self.max_epoch):
            self.epoch = epoch
            self.set_freeze_base(bool(epoch < fixbase_epoch and open_layers))
            self.update_lr(epoch)
            self.train(epoch, print_freq=print_freq)
            if self._preempted:
                print('=> Preempted: writing emergency checkpoint '
                      '(epoch {})'.format(epoch))
                self.save_model(epoch, save_dir, force=True)
                restore_signals()
                self.engine_state.training_completed()
                self.engine_state.run_completed()
                return (np.zeros(max(ranks)), 0.0, 0.0, 0.0)
            if (eval_freq > 0 and (epoch + 1) % eval_freq == 0
                    and (epoch + 1) != self.max_epoch
                    and (epoch + 1) >= start_eval):
                cmc, mAP, ssmd, _ = self.test(epoch, **test_kwargs)
                is_best = cmc[0] > best_rank1
                best_rank1 = max(best_rank1, cmc[0])
                self.save_model(epoch, save_dir, cmc=cmc, mAP=mAP, ssmd=ssmd,
                                is_best=is_best)
        restore_signals()
        self.engine_state.training_completed()

        cmc, mAP, ssmd, pxl_acc = (np.zeros(max(ranks)), 0.0, 0.0, 0.0)
        if self.max_epoch > 0:
            print('=> Final test')
            cmc, mAP, ssmd, pxl_acc = self.test(self.epoch, **last_kwargs)
            self.save_model(self.epoch, save_dir, cmc=cmc, mAP=mAP, ssmd=ssmd,
                            is_best=cmc[0] > best_rank1)
        if self.writer is not None:
            self.writer.total_run_timer.stop()
        print('Elapsed {:.0f}s'.format(time.time() - time_start))
        for name, graph in (('train', self._train_graph),
                            ('eval', self._eval_graph)):
            if graph is not None:
                print('CUDA graph of the {} step: eager {}, captures {}, '
                      'replays {}'.format(name, graph.eager_steps,
                                          graph.captures, graph.replays))
        if self.writer is not None:
            self.writer.report_performance(cmc, mAP, ssmd, pxl_acc)
        self.engine_state.run_completed()
        return cmc, mAP, ssmd, pxl_acc

    def train(self, epoch, print_freq=10):
        """One epoch over the train loader; returns the loss meters.
        With ``steps_per_dispatch`` k above 1 the batches run in groups
        of k through ``forward_backward_multi`` (JAX :251-318): the
        engine-state bus sees k batch events, the time meters take the
        group's time per step with weight k, and the loss meters each
        step's terms. ``batch`` and ``data loading`` times are host wall
        clock: a step returns before the device finishes it, so they show
        where the host waits (for the loader, or for the device's
        queue)."""
        losses = MetricsSummary()
        w = self.writer
        batch_time = w.batch_timer if w is not None else TimeMeter()
        data_time = w.data_loading_timer if w is not None else TimeMeter()
        if w is not None:
            w.epoch_timer.start()
        log_freq = self.config.train.batch_log_freq \
            if self.config is not None else 0
        spd = self.steps_per_dispatch
        self.engine_state.epoch_started()
        loader = self.datamanager.train_loader
        num_batches = len(loader)
        if spd > 1:
            loader = group_train_batches(loader, spd)
        done = logged = printed = 0
        end = time.perf_counter()
        for batch in device_prefetch(loader, self.device):
            if self._preempted:
                break
            data_start = time.perf_counter()
            k = int(batch.pop('_k', 0))
            n = k or 1
            for _ in range(n):
                self.engine_state.batch_started()
            if k:
                loss_vec, loss_summary = self.forward_backward_multi(batch)
                loss = loss_vec[-1]
            else:
                loss, loss_summary = self.forward_backward(batch)
            data_time.meter.update((data_start - end) / n, n)
            losses.update(loss_summary)
            batch_time.meter.update((time.perf_counter() - end) / n, n)
            end = time.perf_counter()
            done += n
            for _ in range(n):
                self.engine_state.batch_completed()
            if w is not None and log_freq > 0 and done // log_freq > logged:
                logged = done // log_freq
                # the group's last step's terms
                latest = _last_step(loss_summary) if k else loss_summary
                w.report_global_step(latest, self.engine_state.lr)
            if print_freq > 0 and done // print_freq > printed:
                printed = done // print_freq
                print('epoch: [{}/{}][{}/{}] time {:.3f} data {:.3f} '
                      'loss {:.4f} | {}'.format(
                          epoch + 1, self.max_epoch, done, num_batches,
                          batch_time.meter.avg, data_time.meter.avg,
                          float(loss), losses.summary_str()))
        if w is not None:
            w.epoch_timer.stop()
        self.engine_state.epoch_completed()
        return losses

    def test(self, epoch, dist_metric='euclidean', normalize_feature=False,
             visrank=False, visrank_topk=10, visrank_q_idx_list=None,
             visrank_count=10, save_dir='', use_metric_cuhk03=False,
             ranks=(1, 5, 10, 20), rerank=False, save_features=False,
             **kwargs):
        """Evaluate on every target dataset; returns the last one's
        ``(cmc, mAP, ssmd, pixel_accuracy)``."""
        self.engine_state.test_started()
        last = (np.zeros(max(ranks)), 0.0, 0.0, 0.0)
        for name, loaders in self.datamanager.test_loader.items():
            domain = 'source' if name in self.datamanager.sources else 'target'
            print('##### Evaluating {} ({}) #####'.format(name, domain))
            last = self._evaluate(
                epoch, dataset_name=name, query_loader=loaders['query'],
                gallery_loader=loaders['gallery'], dist_metric=dist_metric,
                normalize_feature=normalize_feature, visrank=visrank,
                visrank_topk=visrank_topk,
                visrank_q_idx_list=visrank_q_idx_list or [],
                visrank_count=visrank_count, save_dir=save_dir,
                use_metric_cuhk03=use_metric_cuhk03, ranks=ranks,
                rerank=rerank, save_features=save_features)
        self.engine_state.test_completed()
        return last
