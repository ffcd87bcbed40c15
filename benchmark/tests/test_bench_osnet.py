"""The ``osnet_x1_0`` configuration and its cell ``train.osnet_x1_0``
on the CPU: the plain OSNet reference against the port's ``osnet_x1_0``
on seeded weights (64x32, batch 4, float32: logits, loss, every
gradient, three amsgrad steps), the cell's counts pinned, a tiny
``train_softmax`` cell run through ``core.run_cell`` (``--trace 1``),
the faults that the real cell's limits must refuse (a step count frozen
at the capture's, a state left unchanged, half of each batch dropped),
the float8 control, ``calibrate.py`` reaching the kind's readings, and
the two new readers on fabricated traces worked out by hand.

Tolerances of the parity: logits and loss 1e-5 relative; the gradients
by each leaf's gap, the norm of the difference over the larger of the
leaf's norm and the median leaf's (the fc's linear bias ahead of its
batch norm has a gradient near rounding), the median leaf's gap 1e-4 and
the worst leaf's 2e-2 (after an amsgrad step a few depthwise weights'
gradients read 5e-3 to 1.5e-2 apart on this seed, with the forward
still within 1e-5); the parameters after each of three amsgrad steps
1e-6 absolute (an update is about lr = 1.5e-3 an element a step)."""
import hashlib
import json
import os
import statistics
import types

import pytest
import torch

from benchmark import calibrate, core
from benchmark.counts import model_counts
from benchmark.grouped_counts import (AMSGRAD_BYTES, conv_bound_bytes,
                                      grouped_convs, trainable_elements)
from benchmark.reference import reference_of
from benchmark.reference import softmax_train as ref_train
from benchmark.reference.layers import precision
from benchmark.tests.tiny_osnet import (CELL, REAL, tiny_osnet_cell,
                                        tiny_osnet_root)
from benchmark.trace import Trace
from benchmark.weights import make_weights
from bpbreid_tpu_torch.engine.image.softmax import ImageSoftmaxEngine
from bpbreid_tpu_torch.losses.cross_entropy import CrossEntropyLoss
from bpbreid_tpu_torch.models import build_model
from bpbreid_tpu_torch.optim import build_optimizer
from bpbreid_tpu_torch.optim.optimizer import OptaxRule

SEED = 3000000043
PEAKS = json.load(open(os.path.join(core.ROOT, 'benchmark', 'peaks.json')))


def _config(**model):
    config = json.load(open(os.path.join(core.ROOT, 'benchmark', 'configs',
                                         'osnet_x1_0.json')))
    config['model'].update(model)
    return config


def test_reference_matches_the_port():
    """Three steps from the seeded weights. Each starts both models from
    the reference's state (parameters and running statistics) and
    compares the logits, the loss and every gradient; then the port's
    amsgrad (its host path on the CPU) steps on the reference's
    gradients and the reference's on its own, and the parameters are
    compared. Each side running on from its own updates would not do: the
    first steps move every element by about the learning rate whatever
    its gradient, so an element whose gradient is within rounding of 0
    moves either way, and the random network carries that on."""
    torch.set_num_threads(2)
    config = _config(height=64, width=32)
    ref = reference_of(config)
    weights = make_weights(ref.state_shapes(config), SEED, 'cpu', ref)
    plain = ref.build(config)
    plain.load_state_dict(weights, strict=True)
    port = build_model('osnet_x1_0', 751, loss='softmax', device='cpu',
                       dtype=torch.float32)
    o = config['optim']
    opt = ref_train.AMSGrad(plain.parameters(), o['lr'], o['weight_decay'],
                            tuple(o['betas']))
    popt = build_optimizer(port, optim='amsgrad', lr=o['lr'],
                           weight_decay=o['weight_decay'])
    assert isinstance(popt, OptaxRule)
    criterion = CrossEntropyLoss(label_smooth=True)
    g = torch.Generator().manual_seed(7)
    plain.train()
    port.train()
    with precision('f32'):
        for step in range(3):
            images = torch.randint(0, 256, (4, 64, 32, 3), generator=g,
                                   dtype=torch.uint8)
            pids = torch.randint(0, 751, (4,), generator=g)
            d = {'flip': torch.rand(4, generator=g) < 0.5}
            port.load_state_dict(plain.state_dict(), strict=True)
            x = ref_train.augment(images, d)
            want, got = plain(x), port(x)
            assert (got - want).norm() <= 1e-5 * want.norm(), step
            loss_ref = ref.smoothed_ce(want, pids)
            loss = criterion(got, pids)
            assert abs(loss.item() - loss_ref.item()) <= \
                1e-5 * loss_ref.item(), step
            opt_grads = [p.grad for p in plain.parameters()]
            assert all(gr is None for gr in opt_grads)
            loss_ref.backward()
            popt.zero_grad()
            loss.backward()
            named = list(zip(plain.named_parameters(),
                             port.named_parameters()))
            med = statistics.median(a.grad.norm().item()
                                    for (_, a), _ in named)
            gaps = {}
            for (name, a), (other, b) in named:
                assert name == other
                scale = max(a.grad.norm().item(), med)
                gaps[name] = (a.grad - b.grad).norm().item() / scale
                b.grad = a.grad.clone()
            assert statistics.median(gaps.values()) <= 1e-4, step
            assert max(gaps.values()) <= 2e-2, (step, max(gaps,
                                                          key=gaps.get))
            before = {n: p.detach().clone()
                      for n, p in plain.named_parameters()}
            opt.step()
            popt.step()
            for p in plain.parameters():
                p.grad = None
            for (name, a), (_, b) in named:
                assert (a - b).abs().max().item() <= 1e-6, (step, name)
                assert (a - before[name]).abs().max() > 0, (step, name)
    assert float(popt.param_groups[0]['step']) == 3


def test_flip_draws_are_the_engines():
    """The reference's draws are the engine's (``sample_train_draws``)
    from generators seeded alike, step after step, and refuse a transform
    it does not apply."""
    from bpbreid_tpu_torch.data.augment import sample_train_draws
    ours = torch.Generator().manual_seed(11)
    theirs = torch.Generator().manual_seed(11)
    for _ in range(3):
        d = ref_train.draws(ours, 16, ['random_flip'])
        e = sample_train_draws(theirs, 16, 64, 32, ('random_flip',))
        assert torch.equal(d['flip'], e['flip'])
        assert e['off'] is None and e['cj'] is None and e['erase'] is None
    with pytest.raises(ValueError, match='rc'):
        ref_train.draws(ours, 4, ['random_flip', 'rc'])


# forward FLOPs an image (2 per multiply-add), the batch norms, the
# sha256 of the JSON list [[name, shape, gets a gradient], ...], the
# depthwise convolutions and the sha256 of [[name, in, out], ...]
PINNED = (1958519808, 80,
          'c6f2fda8c9bd9ce808f55c6466ee5445739fbefc1139ecfc30e993c4b0c5f1e4',
          60,
          '105d5712fd64a9c296ab41f8ebad5ac5365abe67ae034b7f538322a118045fa3')


def test_cell_counts_are_pinned():
    flops, n_bns, bn_digest, n_dw, dw_digest = PINNED
    cell = core.find_cell(REAL)
    counts = model_counts(cell.config, cell.workload)
    assert counts.batch == 64
    assert counts.forward_flops_per_image == flops
    assert len(counts.bns) == n_bns
    assert all(g for _, _, g in counts.bns)
    assert counts.bns[0] == ('conv1.bn', (64, 64, 128, 64), True)
    assert counts.bns[-1] == ('fc.1', (64, 512), True)
    listed = json.dumps([[n, list(s), g] for n, s, g in counts.bns])
    assert hashlib.sha256(listed.encode()).hexdigest() == bn_digest
    assert counts.feature_map is None
    convs = grouped_convs(cell.config, cell.workload)
    assert len(convs) == n_dw
    listed = json.dumps([[n, list(x), list(y)] for n, x, y in convs])
    assert hashlib.sha256(listed.encode()).hexdigest() == dw_digest
    # 20 depthwise convolutions at each of the three stages' maps; a
    # step moves 3 x (input + output) bf16 bytes of each: 1.007 GB
    # forward, 0.90 ms at 3.35 TB/s
    per_stage = [64 * 64 * 64 * 32, 64 * 96 * 32 * 16, 64 * 128 * 16 * 8]
    assert conv_bound_bytes(convs, 2) == sum(20 * 3 * 2 * n * 2
                                             for n in per_stage)
    assert conv_bound_bytes(convs, 2) == 3019898880
    assert trainable_elements(cell.config) == 2554771
    assert AMSGRAD_BYTES * 2554771 == 91971756
    ref = reference_of(cell.config)
    shapes = ref.state_shapes(cell.config)
    ends = sorted(n for n in shapes if ref.ends_residual(n, shapes))
    assert ends == ['conv{}.{}.conv3.bn.weight'.format(s, b)
                    for s in (2, 3, 4) for b in (0, 1)]


def _trace(kernels, steps):
    events = [{'ph': 'X', 'cat': 'kernel', 'name': n, 'ts': ts, 'dur': d}
              for n, ts, d in kernels]
    return Trace(events, steps, 1.0)


def _ctx(traced, config, workload):
    cell = types.SimpleNamespace(config=config, workload=workload,
                                 root=core.ROOT)
    return types.SimpleNamespace(traced=traced, cell=cell, peaks=PEAKS)


def test_new_readers_by_hand():
    """Two steps whose depthwise kernels took twice the bound, and whose
    optimizer kernels took eight times it (the gradients' fill and other
    kernels left out): 50 % and 12.5 %; None without those kernels, and
    the optimizer's None with another optimizer than amsgrad."""
    cell = core.find_cell(REAL)
    dw = core.load_reader('dwconv_roofline.train')
    opt = core.load_reader('optim_roofline.train')
    dw_us = 3019898880 / PEAKS['hbm_bytes_per_s'] * 1e6
    opt_us = 91971756 / PEAKS['hbm_bytes_per_s'] * 1e6
    trace = _trace([
        ('void at::native::conv_depthwise2d_forward_kernel<1, 3>', 0,
         2 * dw_us),
        ('void at::native::conv_depthwise2d_backward_kernel<3, 1>', 0,
         dw_us),
        ('void at::native::conv_depthwise2d_grad_weight_kernel<3>', 0,
         dw_us),
        ('void at::native::multi_tensor_apply_kernel<TensorListMetadata<3>,'
         ' BinaryOpListAlphaFunctor<float, 3, 2, 2>, std::plus<float>>', 0,
         8 * opt_us),
        ('void at::native::multi_tensor_apply_kernel<TensorListMetadata<2>,'
         ' BinaryOpScalarTensorFunctor<float, 2, 1, 1>, std::divides<float>>',
         0, 8 * opt_us),
        ('void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>',
         0, 100.0),
        ('void cudnn::engines_precompiled::nchwToNhwcKernel', 0, 50.0)],
        steps=2)
    assert dw.read(_ctx(trace, cell.config, cell.workload)) == \
        pytest.approx(50.0)
    assert opt.read(_ctx(trace, cell.config, cell.workload)) == \
        pytest.approx(12.5)
    bare = _trace([('void other_kernel', 0, 5.0)], steps=2)
    assert dw.read(_ctx(bare, cell.config, cell.workload)) is None
    assert opt.read(_ctx(bare, cell.config, cell.workload)) is None
    assert dw.read(_ctx(None, cell.config, cell.workload)) is None
    # amsgrad's bytes bound no other optimizer's kernels
    adam = dict(cell.config, optim=dict(cell.config['optim'], name='adam'))
    assert opt.read(_ctx(trace, adam, cell.workload)) is None


def test_tiny_cell_runs_traced_and_correct(tmp_path):
    root = tiny_osnet_root(tmp_path)
    cell = tiny_osnet_cell(root)
    assert cell.kind == 'train_softmax'
    assert [m['name'] for m in cell.end_to_end] == ['train_images_per_s',
                                                    'setup_s']
    listed = {m['name'] for m in cell.per_layer}
    assert {'dwconv_roofline.train', 'optim_roofline.train',
            'mfu.train', 'graph_rebuilds.train'} <= listed
    res = core.run_cell(cell, 2 ** 31 + 19, 0.3, 1, 'cpu')
    assert res['correct'] is True, res['checks']
    assert set(res['checks']) == set(cell.workload['limits'])
    # on the CPU no kernel runs: the device-trace readers find nothing;
    # the FLOPs and the engine's own span are read
    assert {'mfu.train', 'input_copy_ms.train'} <= set(res['metrics'])
    assert 'dwconv_roofline.train' not in res['metrics']
    assert res['attempted'] > 0 and res['failed'] == 0


def test_require_graph_refuses_eager_steps_on_the_card():
    """The kind refuses an engine that would take eager steps on the card
    (as a program whose optimizer reads the host does), before any step,
    and passes one that replays the graph, and any engine on the CPU."""
    from benchmark.traffic.train_softmax import require_graph
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
    eager = types.SimpleNamespace(train_graphs=False, optimizer=opt)
    graph = types.SimpleNamespace(train_graphs=True, optimizer=opt)
    with pytest.raises(RuntimeError, match='eager steps with SGD'):
        require_graph(eager, 'cuda:0')
    require_graph(graph, 'cuda:0')
    require_graph(eager, 'cpu')


def _run(tmp_path):
    cell = tiny_osnet_cell(tiny_osnet_root(tmp_path))
    return core.run_cell(cell, SEED, 0.3, 0, 'cpu')


def _failed(res):
    return [n for n, c in res['checks'].items() if c['value'] > c['limit']]


def test_frozen_step_count(tmp_path, monkeypatch):
    """The bias corrections of step 2 at step 3 (as a graph that baked a
    host step count into its capture would replay them): the third
    update's scale moves by 15 % and more, and ``update3_median_leaf``
    refuses it."""
    scalars = OptaxRule._scalars
    monkeypatch.setattr(OptaxRule, '_scalars', lambda self, group, t:
                        scalars(self, group, t.clamp(max=2)))
    res = _run(tmp_path)
    assert res['correct'] is False
    assert 'update3_median_leaf' in _failed(res)


def test_state_left_unchanged(tmp_path, monkeypatch):
    monkeypatch.setattr(ImageSoftmaxEngine, 'optimizer_step',
                        lambda self, loss: None)
    res = _run(tmp_path)
    assert res['correct'] is False
    # nothing moved: the third step's change reads 1
    assert res['checks']['update3_median_leaf']['value'] > 0.99


def test_half_batch(tmp_path, monkeypatch):
    step = ImageSoftmaxEngine.train_step

    def half(self, imgs, pids, draws=None):
        n = imgs.shape[0] // 2
        return step(self, imgs[:n], pids[:n], draws)
    monkeypatch.setattr(ImageSoftmaxEngine, 'train_step', half)
    res = _run(tmp_path)
    assert res['correct'] is False
    assert _failed(res)


def test_calibrate_reaches_the_kind(tmp_path):
    """``calibrate.py`` on the tiny cell: the sound run, the float8
    control, the half batch and the frozen step count; the control and
    each fault fail at least one of the real cell's limits, the sound
    run none."""
    root = tiny_osnet_root(tmp_path)
    assert calibrate.main(['--workload', CELL, '--seeds', '1',
                           '--controls', '1', '--device', 'cpu'],
                          root=root) == 0
    with open(os.path.join(root, 'chiprun_out',
                           'calibrate_{}.jsonl'.format(CELL))) as f:
        rows = {r['what']: r for r in map(json.loads, f)}
    assert sorted(rows) == ['control', 'fault_frozen_step',
                            'fault_half_batch', 'sound']
    limits = tiny_osnet_cell(root).workload['limits']
    for what, row in rows.items():
        fails = [n for n, lim in limits.items() if row['readings'][n] > lim]
        assert bool(fails) == (what != 'sound'), (what, row['readings'])
    assert rows['control']['precision'] == 'fp8'
