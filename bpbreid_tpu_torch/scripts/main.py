"""Train/test CLI of bpbreid_tpu_torch (port of bpbreid_tpu/scripts/main.py).

    python -m bpbreid_tpu_torch.scripts.main --config-file <yaml> [opts]

Config (YAML merge, then ``key value`` overrides, then the parts count
from the mask grouping) -> data manager -> model -> optimizer and
schedule -> the engine of ``loss.name`` -> ``engine.run``, then, with
``--inference-enabled``, the features of ``inference.input_folder``
(``tools.extract_reid_features``). The engines: ``part_based``
(``ImagePartBasedEngine``, BPBReID), ``softmax`` and ``triplet``
(``engine/image/``: a zoo model such as ``osnet_x1_0`` trained on its
global embedding, computing in ``model.compute_dtype``). The device is
the config's own ``use_gpu``: True (the default) runs on ``cuda`` and
raises where CUDA is missing; ``use_gpu False`` runs on the CPU.

``model.load_weights`` takes the port's checkpoints (``.pt``,
``utils/checkpoint.py``) and torchreid ``.pth`` files
(``utils/torch_weights.py``: a partial, shape-checked load);
``model.resume`` also restores the optimizer and the epoch. With
``model.pretrained`` an HRNet-W32 backbone starts from
``<model.bpbreid.hrnet_pretrained_path>/hrnetv2_w32_imagenet_pretrained.pth``
when that file exists. ``test.int8 True`` tests (and, with
``--inference-enabled``, extracts) through the calibrated int8 graph:
the activation ranges of the first ``test.int8_calib_batches`` query
batches, then every backbone convolution that ``test.int8_skip_patterns``
does not keep in float as an s8 x s8 -> s32 product (``ops/quant.py``).
``data.type video`` trains and tests a zoo model on tracklets
(``data/video.py``: ``VideoDataManager`` over ``mars``, ``ilidsvid``,
``prid2011``, ``dukemtmcvidreid`` or ``synthetic_video``;
``engine/video/``: ``loss.name`` ``softmax`` or ``triplet``, the frame
embeddings pooled by ``video.pooling_method``), with no masks.
``train.n_devices`` above 1 (or 0: every visible card) trains data
parallel, JAX's mesh semantics on ``torch.distributed``
(``parallel/``): the CLI spawns one process a rank (NCCL on
``cuda:<rank>``; with ``use_gpu False``, gloo ranks on the CPU, which
stand in for JAX's forced host devices), each loads the global batch,
and rank 0 writes the files (``run_distributed``). The figures are
drawn without matplotlib: ``test.visrank`` its ranking grids
(``utils/visualization/rankings.py``), ``train.batch_debug_freq`` the
part-based engine's feature maps and batch-hard triplets every that many
steps, ``test.vis_embedding_projection`` the query and gallery
embeddings of each test (``utils/visualization/``).
"""
import argparse
import json
import os
import os.path as osp
import shutil
import sys
import tempfile

import torch

from bpbreid_tpu_torch import resolve_device
from bpbreid_tpu_torch.config import (display_config_diff, engine_run_kwargs,
                                      get_default_config, imagedata_kwargs,
                                      lr_scheduler_kwargs, optimizer_kwargs,
                                      videodata_kwargs)
from bpbreid_tpu_torch.data.datamanager import ImageDataManager
from bpbreid_tpu_torch.data.datasets import get_image_dataset
from bpbreid_tpu_torch.data.video import VideoDataManager
from bpbreid_tpu_torch.engine.image import (ImageSoftmaxEngine,
                                           ImageTripletEngine)
from bpbreid_tpu_torch.engine.video import (VideoSoftmaxEngine,
                                           VideoTripletEngine)
from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
from bpbreid_tpu_torch.models import build_model
from bpbreid_tpu_torch.ops.masks import compute_parts_num_and_names
from bpbreid_tpu_torch.optim import build_lr_scheduler, build_optimizer
from bpbreid_tpu_torch.parallel import distribute_engine
from bpbreid_tpu_torch.parallel.mesh import init_process_group
from bpbreid_tpu_torch.tools.extract_part_based_features import \
    extract_reid_features
from bpbreid_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                load_optimizer_state,
                                                resume_from_checkpoint)
from bpbreid_tpu_torch.utils.engine_state import EngineState
from bpbreid_tpu_torch.utils.logging import Logger
from bpbreid_tpu_torch.utils.tools import set_random_seed
from bpbreid_tpu_torch.utils.torch_weights import (load_torch_state_dict,
                                                   load_torchreid_state_dict)
from bpbreid_tpu_torch.utils.writer import Writer

__all__ = ['build_config', 'build_datamanager', 'build_engine',
           'build_model_engine',
           'n_devices_for', 'maybe_distribute_engine', 'main']

ENGINES = {'part_based': ImagePartBasedEngine, 'softmax': ImageSoftmaxEngine,
           'triplet': ImageTripletEngine}
# data.type video: the engines of loss.name (JAX main.py:121-139 builds
# the triplet one for any loss but softmax)
VIDEO_ENGINES = {'softmax': VideoSoftmaxEngine, 'triplet': VideoTripletEngine}


def refuse_unported(cfg):
    """Raise, before anything is built, for the options of the JAX CLI
    that the port does not have yet, and for the PVPM models, which no
    data manager can feed."""
    if cfg.data.type not in ('image', 'video'):
        raise ValueError("data.type must be 'image' or 'video', got "
                         "{}".format(cfg.data.type))
    if cfg.data.type == 'video' and cfg.loss.name not in VIDEO_ENGINES:
        raise ValueError('data.type video takes loss.name {}, got {}'.format(
            ' or '.join(VIDEO_ENGINES), cfg.loss.name))
    if cfg.loss.name not in ENGINES:
        raise ValueError('unknown loss {} (one of {})'.format(
            cfg.loss.name, ', '.join(ENGINES)))
    if cfg.model.name.startswith('pose_'):
        # JAX's engines call it on the images alone and raise TypeError
        raise ValueError('model {} takes pose heatmaps beside the images '
                         '(forward(x, pose_map)), which no data manager '
                         'gives'.format(cfg.model.name))
    # a requested device count that does not divide the batch
    n_devices_for(cfg, verbose=False)


def build_config(args=None, config_file=None, config=None, makedirs=True):
    """Default config <- ``config`` <- ``config_file`` <- the CLI
    arguments; then the parts count, the model config of
    ``model.load_weights`` (with ``model.load_config``: a torchreid
    file's ``config`` entry, else the ``.meta.json`` beside the file),
    and the save dir ``<data.save_dir>/<job_id>``."""
    cfg = get_default_config()
    default_cfg_copy = cfg.clone()
    if config is not None:
        cfg.merge_from_dict(config if isinstance(config, dict)
                            else config.to_dict())
    if config_file:
        cfg.merge_from_file(config_file)
        cfg.project.config_file = os.path.basename(config_file)
    if args is not None:
        if getattr(args, 'root', ''):
            cfg.data.root = args.root
        if getattr(args, 'save_dir', ''):
            cfg.data.save_dir = args.save_dir
        if getattr(args, 'inference_enabled', False):
            cfg.inference.enabled = args.inference_enabled
        if getattr(args, 'sources', None):
            cfg.data.sources = args.sources
        if getattr(args, 'targets', None):
            cfg.data.targets = args.targets
        if getattr(args, 'transforms', None):
            cfg.data.transforms = args.transforms
        if getattr(args, 'job_id', None):
            cfg.project.job_id = args.job_id
        if getattr(args, 'opts', None):
            cfg.merge_from_list(args.opts)
    refuse_unported(cfg)
    masks_config = None          # video datasets carry no part masks
    if cfg.data.type == 'image':
        masks_config = get_image_dataset(
            cfg.data.sources[0]).get_masks_config(cfg.model.bpbreid.masks.dir)
    compute_parts_num_and_names(cfg, masks_config)

    if cfg.model.load_weights and osp.isfile(cfg.model.load_weights) \
            and cfg.model.load_config:
        ckpt_cfg = None
        if is_torchreid_file(cfg.model.load_weights):
            ckpt_cfg = load_torch_state_dict(cfg.model.load_weights)[1].get(
                'config')
        meta_path = cfg.model.load_weights + '.meta.json'
        if not ckpt_cfg and osp.exists(meta_path):
            with open(meta_path) as f:
                ckpt_cfg = json.load(f).get('config')
        if ckpt_cfg:
            print('Overwriting current config with config loaded from {}'
                  .format(cfg.model.load_weights))
            sub = ckpt_cfg['model']['bpbreid'] if 'model' in ckpt_cfg \
                else ckpt_cfg
            sub = dict(sub)
            sub.pop('hrnet_pretrained_path', None)
            if isinstance(sub.get('masks'), dict):
                sub['masks'] = {k: v for k, v in sub['masks'].items()
                                if k != 'dir'}
            cfg.merge_from_dict({'model': {'bpbreid': sub}})
        else:
            print('Could not load config from file {}'.format(
                cfg.model.load_weights))

    display_config_diff(cfg, default_cfg_copy)
    cfg.data.save_dir = os.path.join(cfg.data.save_dir,
                                     str(cfg.project.job_id))
    if makedirs:
        os.makedirs(cfg.data.save_dir, exist_ok=True)
    return cfg


def is_torchreid_file(path):
    """Port checkpoints end in ``.pt`` (``utils/checkpoint.py``) and JAX
    ones in ``.ckpt``; any other file is read as a torchreid state dict."""
    return not path.endswith(('.pt', '.ckpt'))


def load_pretrained_weights(engine, path):
    """A port checkpoint: the model's and the optimizer's state (a JAX
    ``.ckpt`` raises). Any other file: a partial, shape-checked load of
    its torchreid state dict into the model; returns ``(matched,
    discarded)`` (``utils.torch_weights.load_torchreid_state_dict``)."""
    if not is_torchreid_file(path):
        payload, _meta = load_checkpoint(path)
        engine.model.load_state_dict(payload['model'])
        if engine.optimizer is not None and payload['optimizer'] is not None:
            load_optimizer_state(engine.optimizer, payload['optimizer'])
        print('Loaded checkpoint from {}'.format(path))
        return None
    sd, _extra = load_torch_state_dict(path)
    matched, discarded = load_torchreid_state_dict(engine.model, sd)
    print('Loaded pretrained weights from {}: {} tensors matched, {} left '
          'at init'.format(path, len(matched), len(discarded)))
    return matched, discarded


def maybe_load_hrnet_imagenet(engine, cfg):
    """The torchreid HRNet-W32 ImageNet file into the model's backbone
    (``backbone_appearance_feature_extractor.``), when the file exists;
    its ImageNet-only heads have no place in the model and stay out.
    Returns ``(matched, discarded)``, or None without the file."""
    path = osp.join(cfg.model.bpbreid.hrnet_pretrained_path,
                    'hrnetv2_w32_imagenet_pretrained.pth')
    if not osp.isfile(path):
        print('HRNet ImageNet weights not found at {}; training from random '
              'init'.format(path))
        return None
    sd, _ = load_torch_state_dict(path)
    prefixed = {'backbone_appearance_feature_extractor.' + k: v
                for k, v in sd.items()}
    matched, discarded = load_torchreid_state_dict(engine.model, prefixed)
    print('Loaded ImageNet HRNet-W32 weights from {} ({} tensors)'.format(
        path, len(matched)))
    return matched, discarded


def build_engine(cfg, datamanager, model, optimizer, scheduler, writer,
                 engine_state, device):
    """The engine of ``loss.name`` (JAX ``build_engine`` :116)."""
    common = dict(optimizer=optimizer, scheduler=scheduler,
                  writer=writer, engine_state=engine_state,
                  save_model_flag=cfg.model.save_model_flag, device=device)
    if cfg.loss.name == 'part_based':
        return ImagePartBasedEngine.from_config(
            cfg, model, datamanager=datamanager, **common)
    kwargs = dict(label_smooth=cfg.loss.softmax.label_smooth, config=cfg,
                  **common)
    if cfg.loss.name == 'triplet':
        kwargs.update(margin=cfg.loss.triplet.margin,
                      weight_t=cfg.loss.triplet.weight_t,
                      weight_x=cfg.loss.triplet.weight_x)
    if cfg.data.type == 'video':
        return VIDEO_ENGINES[cfg.loss.name](
            datamanager, model, pooling_method=cfg.video.pooling_method,
            **kwargs)
    return ENGINES[cfg.loss.name](datamanager, model, **kwargs)


def build_datamanager(cfg):
    """The data manager of ``cfg``: a ``VideoDataManager`` with
    ``data.type video``, else an ``ImageDataManager`` (JAX
    ``build_datamanager`` :35)."""
    if cfg.data.type == 'video':
        return VideoDataManager(**videodata_kwargs(cfg))
    return ImageDataManager(**imagedata_kwargs(cfg))


def build_model_engine(cfg, device=None):
    """Data manager, model, optimizer, schedule and engine of ``cfg`` (from
    ``build_config``, which refuses the unported options) on ``device``
    (by default the one ``cfg.use_gpu`` names); returns ``(engine,
    model)``."""
    device = resolve_device(device or ('cuda' if cfg.use_gpu else 'cpu'))
    set_random_seed(cfg.train.seed)
    if cfg.project.debug_mode:
        torch.autograd.set_detect_anomaly(True)
    datamanager = build_datamanager(cfg)
    engine_state = EngineState(cfg.train.start_epoch, cfg.train.max_epoch)
    writer = Writer(cfg, logger=Logger(cfg), engine_state=engine_state)
    print('Building model: {}'.format(cfg.model.name))
    model = build_model(cfg.model.name, datamanager.num_train_pids,
                        loss=cfg.loss.name, pretrained=cfg.model.pretrained,
                        config=cfg, device=device, seed=cfg.train.seed)
    optimizer = build_optimizer(model, **optimizer_kwargs(cfg))
    scheduler = build_lr_scheduler(lr=cfg.train.lr, **lr_scheduler_kwargs(cfg))
    engine = build_engine(cfg, datamanager, model, optimizer, scheduler,
                          writer, engine_state, device)
    if cfg.model.load_weights and osp.isfile(cfg.model.load_weights):
        load_pretrained_weights(engine, cfg.model.load_weights)
    elif cfg.model.pretrained and cfg.model.bpbreid.backbone == 'hrnet32':
        maybe_load_hrnet_imagenet(engine, cfg)
    if cfg.model.resume and osp.isfile(cfg.model.resume):
        start_epoch, _meta = resume_from_checkpoint(cfg.model.resume, model,
                                                    optimizer)
        cfg.train.start_epoch = start_epoch
        engine.start_epoch = engine.epoch = start_epoch
    return engine, model


def n_devices_for(cfg, available=None, verbose=True):
    """The number of ranks for ``cfg`` by JAX's rules and messages
    (``maybe_distribute_engine``, bpbreid_tpu/scripts/main.py:215-262):
    ``train.n_devices`` 0 means every visible device; a count above the
    visible ones is clamped; a requested count that does not divide
    ``train.batch_size`` raises ``ValueError`` naming the largest divisor
    that fits, while an automatic count shrinks to it. ``available``:
    the visible cards with ``use_gpu`` (``torch.cuda.device_count()``);
    on the CPU a requested count is taken as given (gloo processes stand
    in for JAX's forced host devices) and the automatic count is 1.
    Returns 1 for a one-process run; ``verbose`` prints JAX's messages."""
    say = print if verbose else (lambda *args: None)
    requested = getattr(cfg.train, 'n_devices', 0)
    if available is None:
        available = torch.cuda.device_count() if cfg.use_gpu \
            else max(1, requested)
    n = requested or available
    if n <= 1:
        return 1
    if n > available:
        say('train.n_devices={} but only {} devices visible; using {}'
            .format(cfg.train.n_devices, available, available))
        n = available
        if n <= 1:
            return 1
    if cfg.train.batch_size % n:
        # the largest divisor of batch_size that fits the visible devices
        best = max(d for d in range(1, n + 1)
                   if cfg.train.batch_size % d == 0)
        if requested:
            raise ValueError(
                'train.batch_size={} is not divisible by the {}-device '
                'mesh; set train.batch_size to a multiple of {} (or '
                'train.n_devices to a divisor of the batch size, e.g. '
                'n_devices={})'.format(cfg.train.batch_size, n, n, best))
        n = best
        if n <= 1:
            say('auto mesh: batch_size {} shares no divisor >1 with '
                'the {} visible devices; single-device'.format(
                    cfg.train.batch_size, available))
            return 1
        say('auto mesh: batch_size {} -> using {} of {} visible '
            'devices'.format(cfg.train.batch_size, n, available))
    return n


def maybe_distribute_engine(engine, cfg, mesh=None):
    """Data parallelism for the CLI path (JAX :215): with more than one
    rank by ``n_devices_for``'s rules, ``parallel.distribute_engine`` over
    ``mesh`` (the initialized process group's when None); returns the
    mesh, or None for a one-process run."""
    n = n_devices_for(cfg)
    if n <= 1:
        return None
    return _distribute(engine, mesh, n)


def _distribute(engine, mesh, n):
    mesh = distribute_engine(engine, mesh, n_devices=n)
    print('Distributed training over a {}-rank "{}" mesh (batch sharded, '
          'params replicated, BN statistics and gradients all-reduced over '
          '{})'.format(mesh.size, ','.join(mesh.axis_names), mesh.backend))
    return mesh


def run(cfg, engine):
    """``engine.run`` as the config asks, then the inference on
    ``inference.input_folder`` (rank 0 alone under a mesh), and the
    logger's scalars to ``scalars.json`` with ``project.logger.save_disk``;
    returns what ``engine.run`` returns."""
    print('Starting experiment {} with job id {}'.format(
        cfg.project.experiment_id, cfg.project.job_id))
    result = engine.run(**engine_run_kwargs(cfg),
                        max_epoch=cfg.train.max_epoch,
                        eval_freq=cfg.train.eval_freq,
                        start_eval=cfg.test.start_eval)
    if cfg.inference.enabled and engine.writes:
        print('Starting inference on external data')
        extract_reid_features(cfg, cfg.inference.input_folder,
                              cfg.data.save_dir, engine=engine)
    if cfg.project.logger.save_disk and engine.writer is not None \
            and engine.writer.logger is not None:
        # the scalars to <save_dir>/scalars.json (JAX keeps them in memory)
        engine.writer.logger.flush()
    return result


def _rank_main(rank, n, cfg, init_method, results):
    """One rank of a data-parallel CLI run: NCCL on ``cuda:<rank>``, or
    gloo on the CPU with ``use_gpu False``. Rank 0 prints, writes the
    files (``distribute_engine`` leaves the writer to it) and puts
    ``engine.run``'s result on ``results``."""
    import torch.distributed as dist
    if rank:
        sys.stdout = open(os.devnull, 'w')
        # a Logger opens its backends (TensorBoard's files, W&B's run)
        # when it is built
        cfg.project.logger.use_tensorboard = False
        cfg.project.logger.use_wandb = False
    if cfg.use_gpu:
        device, backend = 'cuda:{}'.format(rank), 'nccl'
    else:
        device, backend = 'cpu', 'gloo'
        # the host's cores shared by the ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    mesh = init_process_group(rank, n, init_method, backend, device)
    try:
        engine, _model = build_model_engine(cfg, device)
        _distribute(engine, mesh, n)
        result = run(cfg, engine)
        if rank == 0:
            results.put(result)
    finally:
        dist.destroy_process_group()


def run_distributed(cfg, n):
    """``n`` ranks of the CLI (``torch.multiprocessing``, spawned), which
    meet through a file in a temporary directory; the CUDA kernels are
    built here first, so the ranks do not each run nvcc. Returns rank 0's
    result; a rank that fails fails the run."""
    import torch.multiprocessing as mp
    if cfg.use_gpu:
        from bpbreid_tpu_torch.ops.cuda.build import build_kernels
        build_kernels()
    ctx = mp.get_context('spawn')
    results = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix='bpbreid_ranks_')
    try:
        mp.start_processes(_rank_main, args=(
            n, cfg, 'file://' + osp.join(tmp, 'rendezvous'), results),
            nprocs=n, join=True, start_method='spawn')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return results.get()


def main(argv=None):
    """Parse ``argv``, build and run; returns ``(engine, result)`` with
    ``result`` what ``engine.run`` returns. A data-parallel run
    (``n_devices_for`` above 1) runs in spawned ranks and returns
    ``(None, result)``, rank 0's result."""
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--config-file', type=str, default='')
    parser.add_argument('-s', '--sources', type=str, nargs='+')
    parser.add_argument('-t', '--targets', type=str, nargs='+')
    parser.add_argument('--transforms', type=str, nargs='+')
    parser.add_argument('--root', type=str, default='')
    parser.add_argument('--save_dir', type=str, default='')
    parser.add_argument('--job-id', type=int, default=None)
    parser.add_argument('--inference-enabled', action='store_true')
    parser.add_argument('opts', default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = build_config(args, args.config_file)
    n = n_devices_for(cfg)
    if n > 1:
        return None, run_distributed(cfg, n)
    engine, _model = build_model_engine(cfg)
    return engine, run(cfg, engine)


if __name__ == '__main__':
    main()
