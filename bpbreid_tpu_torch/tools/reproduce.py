"""Reproduce a checkpoint's evaluation: load -> test -> compare (port of
bpbreid_tpu/tools/reproduce.py).

    python -m bpbreid_tpu_torch.tools.reproduce \\
        --checkpoint bpbreid_market1501_hrnet32_10642.pth \\
        --root $REID_DATA [--dataset market1501] [--max-delta 1e-3] [opts ...]

The checkpoint is a torchreid ``.pth`` (the state dict, the stored
``rank1`` / ``mAP`` and the full config, as torchreid's
``save_checkpoint`` writes it) or the port's own ``.pt`` (its metrics in
the ``.meta.json`` beside it). Its config restores the model
(``scripts.main.build_config`` with ``model.load_config``), the weights
load into the port's model, the engine tests query against gallery, and
the resulting mAP and rank-1 are printed beside the stored numbers as a
delta table; ``main`` exits with 1 when ``--max-delta`` is exceeded.
Unlike JAX, a checkpoint whose stored metrics cannot be read raises; a
file without the metric keys prints ``n/a``.
"""
import argparse
import json
import os.path as osp
import types

__all__ = ['reproduce', 'main', 'stored_metrics']


def stored_metrics(checkpoint):
    """The ``rank1``, ``mAP``, ``ssmd`` and ``epoch`` stored with a
    checkpoint (the ones it holds, as floats)."""
    from bpbreid_tpu_torch.scripts.main import is_torchreid_file
    from bpbreid_tpu_torch.utils.checkpoint import load_checkpoint
    from bpbreid_tpu_torch.utils.torch_weights import load_torch_state_dict
    if is_torchreid_file(checkpoint):
        extra = load_torch_state_dict(checkpoint)[1]
    else:
        extra = load_checkpoint(checkpoint)[1]
    return {key: float(extra[key]) for key in ('rank1', 'mAP', 'ssmd', 'epoch')
            if extra.get(key) is not None}


def reproduce(checkpoint, root, dataset='market1501', config_file=None,
              opts=None, save_dir=None, max_delta=None, masks_dir=None):
    """Run the load -> test -> compare flow; returns a result dict
    (``mAP``, ``rank1``, ``ssmd``, ``stored``, ``delta_mAP``,
    ``delta_rank1`` (nan without a stored value), ``ok``)."""
    from bpbreid_tpu_torch.scripts.main import build_config, build_model_engine

    args = types.SimpleNamespace(
        root=root, save_dir=save_dir or osp.join(root, 'reproduce_log'),
        sources=[dataset], targets=[dataset], transforms=None, job_id=None,
        inference_enabled=False,
        # the evaluation-only semantics of the reference *_test.yaml
        opts=['test.evaluate', 'True', 'model.load_weights', checkpoint,
              'model.load_config', 'True'] + list(opts or []))
    if masks_dir:
        args.opts += ['model.bpbreid.masks.dir', masks_dir]

    cfg = build_config(args, config_file)
    engine, _model = build_model_engine(cfg)
    cmc, mAP, ssmd, _pxl = engine.test(
        0, dist_metric=cfg.test.dist_metric,
        normalize_feature=cfg.test.normalize_feature,
        save_dir=cfg.data.save_dir, ranks=(1, 5, 10, 20),
        rerank=cfg.test.rerank)

    stored = stored_metrics(checkpoint)
    result = {'dataset': dataset, 'mAP': float(mAP),
              'rank1': float(cmc[0]), 'ssmd': float(ssmd),
              'stored': stored}
    print('\n== reproduction vs checkpoint ==')
    print('{:<10} {:>12} {:>12} {:>10}'.format(
        'metric', 'reproduced', 'checkpoint', 'delta'))
    for key, got in (('mAP', result['mAP']), ('rank1', result['rank1'])):
        want = stored.get(key)
        delta = (got - want) if want is not None else float('nan')
        print('{:<10} {:>12.4f} {:>12} {:>10}'.format(
            key, got,
            '{:.4f}'.format(want) if want is not None else 'n/a',
            '{:+.4f}'.format(delta) if want is not None else 'n/a'))
        result['delta_' + key] = delta
    ok = True
    if max_delta is not None:
        for key in ('mAP', 'rank1'):
            want = stored.get(key)
            if want is not None and abs(result['delta_' + key]) > max_delta:
                ok = False
                print('FAIL: |{} delta| {:.4f} > {}'.format(
                    key, abs(result['delta_' + key]), max_delta))
    result['ok'] = ok
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--checkpoint', required=True,
                        help='torchreid .pth or the port\'s .pt')
    parser.add_argument('--root', required=True, help='datasets root')
    parser.add_argument('--dataset', default='market1501')
    parser.add_argument('--config-file', default=None,
                        help='optional *_test.yaml under the '
                             'checkpoint-embedded config')
    parser.add_argument('--save_dir', default=None)
    parser.add_argument('--masks-dir', default=None,
                        help='confidence-fields directory name (e.g. '
                             'pifpaf_maskrcnn_filtering); omit to test '
                             'without external masks')
    parser.add_argument('--max-delta', type=float, default=None,
                        help='fail (exit 1) when |reproduced - stored| '
                             'mAP/rank-1 exceeds this')
    parser.add_argument('--json-out', default=None)
    parser.add_argument('opts', nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    result = reproduce(args.checkpoint, args.root, args.dataset,
                       config_file=args.config_file, opts=args.opts,
                       save_dir=args.save_dir, max_delta=args.max_delta,
                       masks_dir=args.masks_dir)
    if args.json_out:
        with open(args.json_out, 'w') as f:
            json.dump(result, f, indent=1)
    return 0 if result['ok'] else 1


if __name__ == '__main__':
    raise SystemExit(main())
