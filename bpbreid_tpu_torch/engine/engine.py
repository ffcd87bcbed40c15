"""Engine base: the train/test loop (port of bpbreid_tpu/engine/engine.py).

``run()`` drives epochs -> train -> periodic and final test ->
checkpoint, with the frozen-base epochs of two-stepped transfer learning
(``fixbase_epoch``, ``open_layers``), resume (``start_epoch``) and
graceful preemption: SIGTERM or SIGINT stops training at the next batch,
writes an emergency checkpoint and returns zeros. One train step a
batch: the JAX package's grouped dispatch (``steps_per_dispatch``,
``batches_per_dispatch``) is a TPU dispatch trick with the same math.

``device_prefetch`` moves the next batches to the device while the
current step computes.
"""
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bpbreid_tpu_torch.utils.avgmeter import MetricsSummary, TimeMeter
from bpbreid_tpu_torch.utils.checkpoint import save_checkpoint
from bpbreid_tpu_torch.utils.engine_state import EngineState

__all__ = ['Engine', 'device_prefetch', 'normalize']

DEVICE_KEYS = ('image', 'mask', 'pid')
# batches copied ahead of the one the step reads
PREFETCH_DEPTH = 2


def normalize(features, dim=-1):
    """L2-normalize along ``dim`` in f32 (JAX ``Engine.normalize``
    :352)."""
    f = features.float()
    return f / f.norm(dim=dim, keepdim=True).clamp(min=1e-12)


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
    ``forward_backward`` (through ``optimizer_step``) and ``_evaluate``,
    and set ``model``, ``optimizer``, ``scheduler``, ``open_layers`` and
    ``save_model_flag``."""

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
        moments still apply to it."""
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        for name, p in self.model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif self._freeze_base and not any(ol in name
                                               for ol in self.open_layers):
                p.grad.zero_()
        self.optimizer.step()

    def save_model(self, epoch, save_dir, cmc=None, mAP=None, ssmd=None,
                   is_best=False, force=False):
        """Write a checkpoint (``utils/checkpoint.py``) when
        ``save_model_flag`` or ``force`` (preemption) is set; returns its
        path or None."""
        if not self.save_model_flag and not force:
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
        ``(cmc, mAP, ssmd, pixel_accuracy)`` of the last test."""
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
        if self.writer is not None:
            self.writer.report_performance(cmc, mAP, ssmd, pxl_acc)
        self.engine_state.run_completed()
        return cmc, mAP, ssmd, pxl_acc

    def train(self, epoch, print_freq=10):
        """One epoch over the train loader; returns the loss meters.
        ``batch`` and ``data loading`` times are host wall clock: a step
        returns before the device finishes it, so they show where the
        host waits (for the loader, or for the device's queue)."""
        losses = MetricsSummary()
        w = self.writer
        batch_time = w.batch_timer if w is not None else TimeMeter()
        data_time = w.data_loading_timer if w is not None else TimeMeter()
        if w is not None:
            w.epoch_timer.start()
        log_freq = self.config.train.batch_log_freq \
            if self.config is not None else 0
        self.engine_state.epoch_started()
        num_batches = len(self.datamanager.train_loader)
        done = logged = printed = 0
        end = time.perf_counter()
        for batch in device_prefetch(self.datamanager.train_loader,
                                     self.device):
            if self._preempted:
                break
            data_start = time.perf_counter()
            self.engine_state.batch_started()
            loss, loss_summary = self.forward_backward(batch)
            data_time.meter.update(data_start - end)
            losses.update(loss_summary)
            batch_time.meter.update(time.perf_counter() - end)
            end = time.perf_counter()
            done += 1
            self.engine_state.batch_completed()
            if w is not None and log_freq > 0 and done // log_freq > logged:
                logged = done // log_freq
                w.report_global_step(loss_summary, self.engine_state.lr)
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
