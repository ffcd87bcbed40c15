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
Not ported, and raising with its ROADMAP Queue 1 item: data
parallelism over several cards (8). The figures are drawn without
matplotlib: ``test.visrank`` its ranking grids
(``utils/visualization/rankings.py``), ``train.batch_debug_freq`` the
part-based engine's feature maps and batch-hard triplets every that many
steps, ``test.vis_embedding_projection`` the query and gallery
embeddings of each test (``utils/visualization/``).
"""
import argparse
import json
import os
import os.path as osp

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
from bpbreid_tpu_torch.tools.extract_part_based_features import \
    extract_reid_features
from bpbreid_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                resume_from_checkpoint)
from bpbreid_tpu_torch.utils.engine_state import EngineState
from bpbreid_tpu_torch.utils.logging import Logger
from bpbreid_tpu_torch.utils.tools import set_random_seed
from bpbreid_tpu_torch.utils.torch_weights import (load_torch_state_dict,
                                                   load_torchreid_state_dict)
from bpbreid_tpu_torch.utils.writer import Writer

__all__ = ['build_config', 'build_engine', 'build_model_engine', 'main']

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
    if cfg.train.n_devices > 1:
        raise NotImplementedError(
            'train.n_devices {}: data parallelism is not ported yet (ROADMAP '
            'Queue 1 item 8)'.format(cfg.train.n_devices))


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
            engine.optimizer.load_state_dict(payload['optimizer'])
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


def build_model_engine(cfg):
    """Data manager, model, optimizer, schedule and engine of ``cfg`` (from
    ``build_config``, which refuses the unported options) on the device
    ``cfg.use_gpu`` names; returns ``(engine, model)``."""
    device = resolve_device('cuda' if cfg.use_gpu else 'cpu')
    logger = Logger(cfg)
    set_random_seed(cfg.train.seed)
    if cfg.project.debug_mode:
        torch.autograd.set_detect_anomaly(True)
    datamanager = VideoDataManager(**videodata_kwargs(cfg)) \
        if cfg.data.type == 'video' \
        else ImageDataManager(**imagedata_kwargs(cfg))
    engine_state = EngineState(cfg.train.start_epoch, cfg.train.max_epoch)
    writer = Writer(cfg, logger=logger, engine_state=engine_state)
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


def main(argv=None):
    """Parse ``argv``, build and run; returns ``(engine, result)`` with
    ``result`` what ``engine.run`` returns."""
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
    engine, _model = build_model_engine(cfg)
    print('Starting experiment {} with job id {}'.format(
        cfg.project.experiment_id, cfg.project.job_id))
    result = engine.run(**engine_run_kwargs(cfg),
                        max_epoch=cfg.train.max_epoch,
                        eval_freq=cfg.train.eval_freq,
                        start_eval=cfg.test.start_eval)
    if cfg.inference.enabled:
        print('Starting inference on external data')
        extract_reid_features(cfg, cfg.inference.input_folder,
                              cfg.data.save_dir, engine=engine)
    return engine, result


if __name__ == '__main__':
    main()
