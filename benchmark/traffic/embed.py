"""Traffic kind ``embed``: gallery indexing. One client sends requests of
``batches_per_request`` batches of ``ids`` x ``instances`` crops with
their PifPaf fields, back to back (a closed loop); each request is the
engine's ``feature_extraction`` over its batches (one dispatch group of
``test.batches_per_dispatch``, through the eval step's CUDA graph on the
card), timed from the call until its features and visibility scores are
on the host.

Set-up makes a pool of ``pool_requests`` distinct seeded requests as a
loader hands them (numpy arrays), makes the weights and sets their batch
norms' running statistics from the reference model on the first batch
(``weights.calibrate_bn``), builds the engine and runs one request to warm
the graph. The check draws ``checked_requests`` of the window's requests
from the seed and compares their features and visibility with the plain
reference's on the same crops.
"""
import copy
import gc
import random
import statistics
import time

import torch

from benchmark import compare, data
from benchmark.core import percentile
from benchmark.port import build_engine
from benchmark.reference import reference_of
from benchmark.reference.layers import precision
from benchmark.reference.train import eval_images
from benchmark.weights import calibrate_bn, make_weights

__all__ = ['Traffic', 'TRAINS', 'calibration_readings']

TRAINS = False


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.workload = ctx.cell.config, ctx.cell.workload
        self.engine = self.model = None
        self.outputs = []

    @property
    def ref(self):
        """The configuration's plain reference module."""
        return reference_of(self.config, self.ctx.cell.root)

    def _sync(self):
        if torch.device(self.ctx.device).type == 'cuda':
            torch.cuda.synchronize(self.ctx.device)

    def setup(self):
        ctx, dev = self.ctx, self.ctx.device
        per = int(self.workload['batches_per_request'])
        n = per * int(self.workload['pool_requests'])
        images, fields, pids = data.make_batches(ctx.seed + 1, n,
                                                 self.workload, self.config,
                                                 dev)
        weights = make_weights(self.ref.state_shapes(self.config), ctx.seed,
                               dev, self.ref)
        with precision('f32'):
            model = self.ref.build(self.config, dev)
            model.load_state_dict(weights, strict=True)
            weights.update(calibrate_bn(model, eval_images(images[0])))
        del model
        self.host_weights = {k: v.cpu() for k, v in weights.items()}
        images, fields, pids = images.cpu().numpy(), fields.cpu().numpy(), \
            pids.cpu().numpy()
        self.pool = [[{'image': images[b], 'mask': fields[b], 'pid': pids[b],
                       'camid': pids[b] * 0}
                      for b in range(r * per, (r + 1) * per)]
                     for r in range(n // per)]
        self.crops = per * images.shape[1]
        self.engine, self.model = build_engine(self.config, self.workload,
                                               ctx.seed + 2, weights, dev,
                                               train=False)
        del weights
        self._request(0)
        self._sync()

    def _request(self, i):
        feats, vis, _pids, _camids, _acc = self.engine.feature_extraction(
            self.pool[i % len(self.pool)])
        return feats.cpu(), vis.cpu()

    def window(self, seconds):
        self._sync()
        latencies, self.outputs = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            f, v = self._request(len(latencies))
            latencies.append(time.perf_counter() - ts)
            self.outputs.append((len(latencies) - 1, f, v))
        dt = time.perf_counter() - t0
        n = len(latencies)
        return {'attempted': n, 'requests': n, 'images': n * self.crops,
                'seconds': dt, 'steps': n * int(
                    self.workload['batches_per_request']),
                'latencies': latencies,
                'metrics': {'embed_images_per_s': n * self.crops / dt,
                            'embed_ms_p90': percentile(latencies, 90) * 1e3}}

    def traced(self):
        from benchmark.trace import profile
        requests = int(self.workload.get('traced_requests', 2))
        return profile(lambda: [self._request(i) for i in range(requests)],
                       requests * int(self.workload['batches_per_request']),
                       self.ctx.device)

    def release(self):
        self.engine = self.model = None
        gc.collect()
        if torch.device(self.ctx.device).type == 'cuda':
            torch.cuda.empty_cache()

    def sample(self):
        """The window's requests the check compares, drawn from the
        seed."""
        k = min(int(self.workload['checked_requests']), len(self.outputs))
        return random.Random(self.ctx.seed).sample(range(len(self.outputs)),
                                                   k)

    def reference(self, requests, mode='f32'):
        """The reference's ``(features [N, 1 + K, D], visibility
        [N, 1 + K])`` (``bn_foreg`` and the parts) for each pool request in
        ``requests``."""
        dev = self.ctx.device
        out = []
        with precision(mode), torch.no_grad():
            model = self.ref.build(self.config, dev)
            model.load_state_dict(self.host_weights, strict=True)
            model.eval()
            for request in requests:
                feats, vis = [], []
                for batch in self.pool[request % len(self.pool)]:
                    o = model(eval_images(torch.as_tensor(batch['image'])
                                          .to(dev)))
                    feats.append(torch.cat([o['emb']['bn_foreg'][:, None],
                                            o['emb']['parts']], dim=1).cpu())
                    vis.append(torch.cat([o['visibility']['foreg'][:, None],
                                          o['visibility']['parts']],
                                         dim=1).cpu())
                out.append((torch.cat(feats), torch.cat(vis)))
        del model
        return out

    def readings(self, outputs, reference):
        """Every candidate number from ``[(feats, vis)]`` of the program
        and of the reference on the same requests."""
        pairs = [(f.float(), rf) for (f, _), (rf, _) in zip(outputs,
                                                             reference)]
        gaps = torch.cat([compare.crop_gaps(f, rf) for f, rf in pairs])
        # as retrieval reads them: each embedding L2-normalized
        units = torch.cat([compare.crop_gaps(compare.unit(f),
                                             compare.unit(rf))
                           for f, rf in pairs])
        mism = [compare.mismatch_share(v, rv) for (_, v), (_, rv)
                in zip(outputs, reference)]
        return {'feature_worst_crop': float(gaps.max()),
                'feature_median_crop': float(gaps.median()),
                'unit_worst_crop': float(units.max()),
                'visibility_mismatch': statistics.mean(mism)}

    def check(self):
        picked = [self.outputs[i] for i in self.sample()]
        readings = self.readings([(f, v) for _, f, v in picked],
                                 self.reference([r for r, _, _ in picked]))
        return {name: compare.check(readings[name], limit)
                for name, limit in self.workload['limits'].items()}


def calibration_readings(ctx_for, seed, controls, seconds):
    """``[(what, readings, extra)]`` for ``benchmark/calibrate.py``: the
    sound run's after a window of ``seconds``, and with ``controls`` the
    program's own int8 path on the same requests (``control``) and the
    float8 reference beside it (``control_fp8``)."""
    tr = ctx_for(seed)
    tr.setup()
    tr.window(seconds)
    picked = [tr.outputs[i] for i in tr.sample()]
    requests = [r for r, _, _ in picked]
    tr.release()
    ref = tr.reference(requests)
    rows = [('sound', tr.readings([(f, v) for _, f, v in picked], ref), {})]
    if controls:
        workload = copy.deepcopy(tr.workload)
        workload.setdefault('port', {}).setdefault('test', {})['int8'] = True
        weights = {k: v.to(tr.ctx.device) for k, v in tr.host_weights.items()}
        tr.engine, tr.model = build_engine(tr.config, workload,
                                           tr.ctx.seed + 2, weights,
                                           tr.ctx.device, train=False)
        del weights
        int8 = [tr._request(r) for r in requests]
        tr.release()
        rows.append(('control', tr.readings(int8, ref), {'path': 'int8'}))
        rows.append(('control_fp8', tr.readings(
            tr.reference(requests, 'fp8'), ref), {}))
    del tr
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return rows
