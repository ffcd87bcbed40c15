"""Configuration system (the port's own copy of bpbreid_tpu/config.py).

A dataclass tree mirroring the reference's yacs option space
(reference: torchreid/scripts/default_config.py:11-214) with the same
group/option names, plus YAML-file merge, dotted-key CLI override merge,
kwargs adapters and a diff-vs-default display. Checkpoint-embedded
configs round-trip through ``to_dict``/``merge_from_dict``.
"""
import copy
import dataclasses
import pprint
import random
import uuid
from dataclasses import dataclass, field
from datetime import datetime
from typing import Any, Dict, List

import yaml

from bpbreid_tpu_torch.constants import CONCAT_PARTS, FOREGROUND, GLOBAL, PARTS, PIXELS

__all__ = ['get_default_config', 'Config', 'imagedata_kwargs',
           'optimizer_kwargs', 'lr_scheduler_kwargs', 'engine_run_kwargs',
           'display_config_diff']


def _f(default):
    return field(default_factory=lambda: copy.deepcopy(default))


@dataclass
class LoggerCfg:
    use_clearml: bool = False
    use_neptune: bool = False
    use_tensorboard: bool = False
    use_wandb: bool = False
    matplotlib_show: bool = False
    save_disk: bool = True


@dataclass
class ProjectCfg:
    name: str = 'BPBreID'
    experiment_name: str = ''
    diff_config: str = ''
    notes: str = ''
    tags: List[str] = _f([])
    config_file: str = ''
    debug_mode: bool = False
    logger: LoggerCfg = field(default_factory=LoggerCfg)
    job_id: int = field(default_factory=lambda: random.randint(0, 1_000_000_000))
    experiment_id: str = field(default_factory=lambda: str(uuid.uuid4()))
    start_time: str = field(default_factory=lambda: datetime.now().strftime('%Y_%m_%d_%H_%M_%S'))


@dataclass
class MasksCfg:
    type: str = 'disk'
    parts_num: int = 1
    parts_names: List[str] = _f(['p1'])
    dir: str = 'pifpaf_maskrcnn_filtering'
    preprocess: str = 'eight'
    softmax_weight: float = 15.0
    background_computation_strategy: str = 'threshold'
    mask_filtering_threshold: float = 0.5


@dataclass
class BPBreIDCfg:
    pooling: str = 'gwap'
    normalization: str = 'identity'
    mask_filtering_training: bool = False
    mask_filtering_testing: bool = True
    last_stride: int = 1
    dim_reduce: str = 'after_pooling'
    dim_reduce_output: int = 512
    backbone: str = 'resnet50'
    learnable_attention_enabled: bool = True
    test_embeddings: List[str] = _f(['bn_foreg', 'parts'])
    test_use_target_segmentation: str = 'none'
    training_binary_visibility_score: bool = True
    testing_binary_visibility_score: bool = True
    shared_parts_id_classifier: bool = False
    use_pallas_pooling: bool = False
    multires_pooling: bool = True
    hrnet_pretrained_path: str = 'pretrained_models/'
    masks: MasksCfg = field(default_factory=MasksCfg)


@dataclass
class ModelCfg:
    name: str = 'bpbreid'
    pretrained: bool = True
    load_weights: str = ''
    load_config: bool = False
    resume: str = ''
    save_model_flag: bool = False
    # compute dtype of the forward pass ('bfloat16' or 'float32');
    # parameters and the optimizer state always stay float32.
    compute_dtype: str = 'bfloat16'
    bpbreid: BPBreIDCfg = field(default_factory=BPBreIDCfg)


@dataclass
class ROCfg:
    path: str = ''
    p: float = 0.5
    n: int = 1
    min_overlap: float = 0.5
    max_overlap: float = 0.8


@dataclass
class CJCfg:
    brightness: float = 0.2
    contrast: float = 0.15
    saturation: float = 0.0
    hue: float = 0.0
    always_apply: bool = False
    p: float = 0.5


@dataclass
class DataCfg:
    type: str = 'image'
    root: str = 'reid-data'
    sources: List[str] = _f(['market1501'])
    targets: List[str] = _f(['market1501'])
    workers: int = 4
    split_id: int = 0
    height: int = 256
    width: int = 128
    combineall: bool = False
    transforms: List[str] = _f(['rc', 're'])
    ro: ROCfg = field(default_factory=ROCfg)
    cj: CJCfg = field(default_factory=CJCfg)
    norm_mean: List[float] = _f([0.485, 0.456, 0.406])
    norm_std: List[float] = _f([0.229, 0.224, 0.225])
    save_dir: str = 'logs'
    load_train_targets: bool = False


@dataclass
class Market1501Cfg:
    use_500k_distractors: bool = False


@dataclass
class CUHK03Cfg:
    labeled_images: bool = False
    classic_split: bool = False
    use_metric_cuhk03: bool = False


@dataclass
class SamplerCfg:
    train_sampler: str = 'RandomIdentitySampler'
    train_sampler_t: str = 'RandomIdentitySampler'
    num_instances: int = 4


@dataclass
class VideoCfg:
    seq_len: int = 15
    sample_method: str = 'evenly'
    pooling_method: str = 'avg'


@dataclass
class TrainCfg:
    optim: str = 'adam'
    lr: float = 0.00035
    weight_decay: float = 5e-4
    max_epoch: int = 120
    start_epoch: int = 0
    batch_size: int = 64
    fixbase_epoch: int = 0
    open_layers: List[str] = _f(['classifier'])
    staged_lr: bool = False
    new_layers: List[str] = _f(['classifier'])
    base_lr_mult: float = 0.1
    lr_scheduler: str = 'warmup_multi_step'
    stepsize: List[int] = _f([40, 70])
    gamma: float = 0.1
    seed: int = 1
    eval_freq: int = -1
    batch_debug_freq: int = 0
    batch_log_freq: int = 0
    # multi-device data parallelism (not ported yet)
    n_devices: int = 0
    # train steps per dispatch (read by the JAX engine; kept so configs load)
    steps_per_dispatch: int = 8


@dataclass
class SGDCfg:
    momentum: float = 0.9
    dampening: float = 0.0
    nesterov: bool = False


@dataclass
class RMSPropCfg:
    alpha: float = 0.99


@dataclass
class AdamCfg:
    beta1: float = 0.9
    beta2: float = 0.999


@dataclass
class LossWeightCfg:
    id: float = 1.0
    tr: float = 0.0


@dataclass
class PixelLossWeightCfg:
    ce: float = 0.35


@dataclass
class PartBasedLossCfg:
    name: str = 'part_averaged_triplet_loss'
    ppl: str = 'cl'
    weights: Dict[str, Any] = _f({
        GLOBAL: {'id': 1.0, 'tr': 0.0},
        FOREGROUND: {'id': 1.0, 'tr': 0.0},
        CONCAT_PARTS: {'id': 1.0, 'tr': 0.0},
        PARTS: {'id': 0.0, 'tr': 1.0},
        PIXELS: {'ce': 0.35},
    })


@dataclass
class SoftmaxLossCfg:
    label_smooth: bool = True


@dataclass
class TripletLossCfg:
    margin: float = 0.3
    weight_t: float = 1.0
    weight_x: float = 0.0


@dataclass
class LossCfg:
    name: str = 'part_based'
    part_based: PartBasedLossCfg = field(default_factory=PartBasedLossCfg)
    softmax: SoftmaxLossCfg = field(default_factory=SoftmaxLossCfg)
    triplet: TripletLossCfg = field(default_factory=TripletLossCfg)


@dataclass
class TestPartBasedCfg:
    dist_combine_strat: str = 'mean'


@dataclass
class TestCfg:
    batch_size: int = 128
    batch_size_pairwise_dist_matrix: int = 500
    dist_metric: str = 'euclidean'
    # eval batches per dispatch (read by the JAX engine; kept so configs load)
    batches_per_dispatch: int = 8
    # calibrated int8 eval (ops/quant.py): the engine, the extractor and
    # the CLI
    int8: bool = False
    int8_calib_batches: int = 4
    int8_calib_percentile: float = 99.9
    int8_skip_patterns: List[str] = _f(['extractor/conv1',
                                        'extractor/conv2'])
    int8_shared_points: bool = True
    int8_act_granularity: str = 'per_tensor'
    normalize_feature: bool = True
    ranks: List[int] = _f([1, 5, 10, 20])
    evaluate: bool = False
    start_eval: int = 0
    rerank: bool = False
    visrank: bool = False
    visrank_topk: int = 10
    visrank_count: int = 10
    visrank_q_idx_list: List[int] = _f([0, 1, 2, 3, 4, 5])
    vis_feature_maps: bool = False
    visrank_per_body_part: bool = False
    vis_embedding_projection: bool = False
    save_features: bool = False
    detailed_ranking: bool = True
    part_based: TestPartBasedCfg = field(default_factory=TestPartBasedCfg)


@dataclass
class InferenceCfg:
    enabled: bool = False
    input_folder: str = ''


@dataclass
class Config:
    project: ProjectCfg = field(default_factory=ProjectCfg)
    model: ModelCfg = field(default_factory=ModelCfg)
    data: DataCfg = field(default_factory=DataCfg)
    market1501: Market1501Cfg = field(default_factory=Market1501Cfg)
    cuhk03: CUHK03Cfg = field(default_factory=CUHK03Cfg)
    sampler: SamplerCfg = field(default_factory=SamplerCfg)
    video: VideoCfg = field(default_factory=VideoCfg)
    train: TrainCfg = field(default_factory=TrainCfg)
    sgd: SGDCfg = field(default_factory=SGDCfg)
    rmsprop: RMSPropCfg = field(default_factory=RMSPropCfg)
    adam: AdamCfg = field(default_factory=AdamCfg)
    loss: LossCfg = field(default_factory=LossCfg)
    test: TestCfg = field(default_factory=TestCfg)
    inference: InferenceCfg = field(default_factory=InferenceCfg)
    use_gpu: bool = True  # kept for reference-API compat; the port takes an explicit device

    # ------------------------------------------------------------------
    def to_dict(self):
        return dataclasses.asdict(self)

    def clone(self):
        return copy.deepcopy(self)

    def merge_from_dict(self, d):
        _merge(self, d, path='cfg')
        return self

    def merge_from_file(self, path):
        with open(path) as f:
            d = yaml.safe_load(f) or {}
        return self.merge_from_dict(d)

    def merge_from_list(self, opts):
        """Merge dotted-key/value pairs (yacs-style CLI remainder)."""
        if len(opts) % 2 != 0:
            raise ValueError('override list must have even length: {}'.format(opts))
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split('.')
            for p in parts[:-1]:
                node = _child(node, p)
            leaf = parts[-1]
            old = _child(node, leaf)
            _set_child(node, leaf, _coerce(value, old))
        return self


def _child(node, name):
    if dataclasses.is_dataclass(node):
        if not hasattr(node, name):
            raise KeyError('unknown config key: {}'.format(name))
        return getattr(node, name)
    elif isinstance(node, dict):
        if name not in node:
            raise KeyError('unknown config key: {}'.format(name))
        return node[name]
    raise KeyError('cannot descend into {} for key {}'.format(type(node), name))


def _set_child(node, name, value):
    if dataclasses.is_dataclass(node):
        setattr(node, name, value)
    else:
        node[name] = value


def _coerce(value, old):
    if isinstance(value, str):
        try:
            value = yaml.safe_load(value)
        except yaml.YAMLError:
            pass
    if old is not None and not isinstance(old, (list, dict)) \
            and value is not None and type(value) is not type(old):
        if isinstance(old, bool):
            if isinstance(value, str):
                value = value.lower() in ('1', 'true', 'yes', 'on')
            else:
                value = bool(value)
        else:
            value = type(old)(value)
    return value


def _merge(node, d, path):
    for k, v in d.items():
        cur = _child(node, k) if (dataclasses.is_dataclass(node) and hasattr(node, k)) \
            or (isinstance(node, dict) and k in node) else None
        if cur is None and not _has(node, k):
            raise KeyError('unknown config key: {}.{}'.format(path, k))
        if isinstance(v, dict) and (dataclasses.is_dataclass(cur) or isinstance(cur, dict)):
            _merge(cur, v, path + '.' + k)
        else:
            _set_child(node, k, _coerce(v, cur))


def _has(node, k):
    if dataclasses.is_dataclass(node):
        return hasattr(node, k)
    return k in node


def get_default_config():
    return Config()


# ---------------------------------------------------------------------------
# kwargs adapters (reference: default_config.py:254-350)
# ---------------------------------------------------------------------------

def imagedata_kwargs(cfg):
    return {
        'config': cfg,
        'root': cfg.data.root,
        'sources': cfg.data.sources,
        'targets': cfg.data.targets,
        'height': cfg.data.height,
        'width': cfg.data.width,
        'transforms': cfg.data.transforms,
        'norm_mean': cfg.data.norm_mean,
        'norm_std': cfg.data.norm_std,
        'split_id': cfg.data.split_id,
        'combineall': cfg.data.combineall,
        'load_train_targets': cfg.data.load_train_targets,
        'batch_size_train': cfg.train.batch_size,
        'batch_size_test': cfg.test.batch_size,
        'workers': cfg.data.workers,
        'num_instances': cfg.sampler.num_instances,
        'train_sampler': cfg.sampler.train_sampler,
        'train_sampler_t': cfg.sampler.train_sampler_t,
        'cuhk03_labeled': cfg.cuhk03.labeled_images,
        'cuhk03_classic_split': cfg.cuhk03.classic_split,
        'market1501_500k': cfg.market1501.use_500k_distractors,
        # stripes mode (PCB emulation) synthesizes its attention masks
        # in-model — don't require disk masks for it (the reference
        # keys only on the loss, default_config.py:279, which makes its
        # own pcb configs demand pifpaf masks they never use)
        'use_masks': (cfg.loss.name == 'part_based'
                      and cfg.model.bpbreid.masks.type == 'disk'),
        'masks_dir': cfg.model.bpbreid.masks.dir,
    }


def videodata_kwargs(cfg):
    """(reference: scripts/default_config.py:284-305)"""
    return {
        'config': cfg,
        'root': cfg.data.root,
        'sources': cfg.data.sources,
        'targets': cfg.data.targets,
        'height': cfg.data.height,
        'width': cfg.data.width,
        'transforms': cfg.data.transforms,
        'norm_mean': cfg.data.norm_mean,
        'norm_std': cfg.data.norm_std,
        'split_id': cfg.data.split_id,
        'combineall': cfg.data.combineall,
        'batch_size_train': cfg.train.batch_size,
        'batch_size_test': cfg.test.batch_size,
        'workers': cfg.data.workers,
        'num_instances': cfg.sampler.num_instances,
        'train_sampler': cfg.sampler.train_sampler,
        'seq_len': cfg.video.seq_len,
        'sample_method': cfg.video.sample_method,
    }


def optimizer_kwargs(cfg):
    return {
        'optim': cfg.train.optim,
        'lr': cfg.train.lr,
        'weight_decay': cfg.train.weight_decay,
        'momentum': cfg.sgd.momentum,
        'sgd_dampening': cfg.sgd.dampening,
        'sgd_nesterov': cfg.sgd.nesterov,
        'rmsprop_alpha': cfg.rmsprop.alpha,
        'adam_beta1': cfg.adam.beta1,
        'adam_beta2': cfg.adam.beta2,
        'staged_lr': cfg.train.staged_lr,
        'new_layers': cfg.train.new_layers,
        'base_lr_mult': cfg.train.base_lr_mult,
    }


def lr_scheduler_kwargs(cfg):
    return {
        'lr_scheduler': cfg.train.lr_scheduler,
        'stepsize': cfg.train.stepsize,
        'gamma': cfg.train.gamma,
        'max_epoch': cfg.train.max_epoch,
    }


def engine_run_kwargs(cfg):
    return {
        'save_dir': cfg.data.save_dir,
        'fixbase_epoch': cfg.train.fixbase_epoch,
        'open_layers': cfg.train.open_layers,
        'test_only': cfg.test.evaluate,
        'dist_metric': cfg.test.dist_metric,
        'normalize_feature': cfg.test.normalize_feature,
        'visrank': cfg.test.visrank,
        'visrank_topk': cfg.test.visrank_topk,
        'visrank_q_idx_list': cfg.test.visrank_q_idx_list,
        'visrank_count': cfg.test.visrank_count,
        'use_metric_cuhk03': cfg.cuhk03.use_metric_cuhk03,
        'ranks': cfg.test.ranks,
        'rerank': cfg.test.rerank,
        'save_features': cfg.test.save_features,
    }


keys_to_ignore_in_diff = {
    'cfg.project', 'cfg.model.save_model_flag', 'cfg.model.bpbreid.backbone',
    'cfg.model.bpbreid.learnable_attention_enabled',
    'cfg.model.bpbreid.masks.parts_num', 'cfg.model.bpbreid.masks.parts_names',
    'cfg.model.bpbreid.masks.dir',
    'cfg.data.type', 'cfg.data.root', 'cfg.data.sources', 'cfg.data.targets',
    'cfg.data.workers', 'cfg.data.split_id', 'cfg.data.combineall',
    'cfg.data.save_dir', 'cfg.train.eval_freq', 'cfg.train.batch_debug_freq',
    'cfg.train.batch_log_freq', 'cfg.test.batch_size',
    'cfg.test.batch_size_pairwise_dist_matrix', 'cfg.test.dist_metric',
    'cfg.test.ranks', 'cfg.test.evaluate', 'cfg.test.start_eval',
    'cfg.test.rerank', 'cfg.test.visrank', 'cfg.test.visrank_topk',
    'cfg.test.visrank_count', 'cfg.test.visrank_q_idx_list',
    'cfg.test.vis_feature_maps', 'cfg.test.visrank_per_body_part',
    'cfg.test.vis_embedding_projection', 'cfg.test.save_features',
    'cfg.test.detailed_ranking', 'cfg.train.open_layers',
    'cfg.model.load_weights',
}


def _flatten(d, prefix):
    out = {}
    for k, v in d.items():
        key = prefix + '.' + str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def display_config_diff(cfg, default_cfg=None, show=True):
    """Diff vs default config, honoring the ignore list; stores a short diff
    string in cfg.project.diff_config (reference: default_config.py:353-386)."""
    default_cfg = default_cfg if default_cfg is not None else Config()
    flat_new = _flatten(cfg.to_dict(), 'cfg')
    flat_old = _flatten(default_cfg.to_dict(), 'cfg')
    diff = {}
    for key, new_v in flat_new.items():
        old_v = flat_old.get(key, None)
        if new_v == old_v:
            continue
        parts = key.split('.')
        if any('.'.join(parts[:i]) in keys_to_ignore_in_diff
               for i in range(2, len(parts) + 1)):
            continue
        diff[parts[-1]] = new_v
    if show:
        print('Diff from default config :')
        pprint.pprint(diff)
    s = str(diff)
    cfg.project.diff_config = s if len(s) < 128 else s[:124] + '...'
    return diff
