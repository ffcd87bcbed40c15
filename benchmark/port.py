"""The system under test: the part-based engine of ``bpbreid_tpu_torch``
built through its public API from a benchmark configuration and a cell's
workload file."""

__all__ = ['port_config', 'build_engine']


def port_config(config, workload, seed):
    """The port's ``Config`` for a benchmark configuration: its model,
    masks, loss and optimizer sections, then the workload's ``port``
    overrides (e.g. the grouped dispatch, the serving graph's pooling)."""
    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.ops.masks import compute_parts_num_and_names
    m, masks, loss, opt = (config[k] for k in ('model', 'masks', 'loss',
                                               'optim'))
    cfg = get_default_config()
    cfg.merge_from_dict({
        'model': {'name': 'bpbreid', 'pretrained': False,
                  'compute_dtype': m['compute_dtype'],
                  'bpbreid': {
                      'backbone': m['backbone'],
                      'last_stride': m.get('last_stride', 1),
                      'dim_reduce': 'after_pooling',
                      'dim_reduce_output': m['dim_reduce_output'],
                      'test_embeddings': list(m['test_embeddings']),
                      'masks': {
                          'preprocess': masks['preprocess'],
                          'softmax_weight': masks['softmax_weight'],
                          'mask_filtering_threshold':
                              masks['mask_filtering_threshold'],
                          'background_computation_strategy': 'threshold'}}},
        'data': {'height': m['height'], 'width': m['width'],
                 'transforms': list(config['transforms'])},
        'loss': {'name': 'part_based',
                 'part_based': {'name': 'part_averaged_triplet_loss',
                                'weights': loss['weights']},
                 'triplet': {'margin': loss['margin']}},
        'train': {'optim': opt['name'], 'lr': opt['lr'],
                  'weight_decay': opt['weight_decay'], 'seed': int(seed)},
        'adam': {'beta1': opt['betas'][0], 'beta2': opt['betas'][1]},
    })
    cfg.merge_from_dict(workload.get('port', {}))
    compute_parts_num_and_names(cfg)
    if cfg.model.bpbreid.masks.parts_num != m['parts_num']:
        raise ValueError('the port groups {} parts, the configuration '
                         'states {}'.format(cfg.model.bpbreid.masks.parts_num,
                                            m['parts_num']))
    return cfg


def build_engine(config, workload, seed, weights, device, train):
    """``(engine, model)``: the port's BPBReID with ``weights`` loaded
    (strict) and its ``ImagePartBasedEngine`` on ``device``, with Adam when
    ``train``."""
    from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.optim import build_optimizer
    cfg = port_config(config, workload, seed)
    model = build_model('bpbreid', config['model']['num_classes'],
                        config=cfg, device=device, seed=int(seed))
    model.load_state_dict(weights, strict=True)
    optimizer = None
    if train:
        optimizer = build_optimizer(
            model, optim=cfg.train.optim, lr=cfg.train.lr,
            weight_decay=cfg.train.weight_decay,
            adam_beta1=cfg.adam.beta1, adam_beta2=cfg.adam.beta2)
    engine = ImagePartBasedEngine.from_config(
        cfg, model, mask_chain_kwargs(cfg), device=device,
        optimizer=optimizer)
    return engine, model
