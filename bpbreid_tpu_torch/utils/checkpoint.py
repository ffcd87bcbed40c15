"""Checkpoint save / load / resume (the port's own format; the JAX
package writes flax msgpack, bpbreid_tpu/utils/checkpoint.py).

A checkpoint is ``job-{job_id}_{epoch}_model.pt``: ``torch.save`` of
``{'format': FORMAT, 'model': state_dict, 'optimizer': state_dict}``,
read back with ``weights_only=True`` (tensors and plain containers, no
pickled code), beside ``<path>.meta.json`` with the JAX package's keys
(epoch, rank1, mAP, ssmd, config). ``is_best`` also copies both to
``model-best.pt``. ``resume_from_checkpoint`` returns ``epoch + 1``.
"""
import json
import os
import os.path as osp
import pickle
import shutil

import torch

__all__ = ['FORMAT', 'save_checkpoint', 'load_checkpoint',
           'resume_from_checkpoint']

FORMAT = 'bpbreid_tpu_torch'


def save_checkpoint(model, optimizer, meta, save_dir, job_id=0, epoch=0,
                    is_best=False):
    """Write ``model``'s (and ``optimizer``'s, when not None) state and
    ``meta``; returns the checkpoint's path."""
    os.makedirs(save_dir, exist_ok=True)
    path = osp.join(save_dir, 'job-{}_{}_model.pt'.format(job_id, epoch))
    torch.save({'format': FORMAT, 'model': model.state_dict(),
                'optimizer': (optimizer.state_dict()
                              if optimizer is not None else None)}, path)
    with open(path + '.meta.json', 'w') as f:
        json.dump(meta, f, default=str)
    if is_best:
        best = osp.join(save_dir, 'model-best.pt')
        shutil.copy(path, best)
        shutil.copy(path + '.meta.json', best + '.meta.json')
    print('Checkpoint saved to "{}"'.format(path))
    return path


def load_checkpoint(path):
    """``(payload, meta)`` of a checkpoint written by ``save_checkpoint``.
    Raises ``NotImplementedError`` for any other ``torch.save`` file (a
    torchreid ``.pth``: ROADMAP Queue 1 item 5) and ``ValueError`` for a
    file ``torch.load`` cannot read (a JAX ``.ckpt``)."""
    if not osp.exists(path):
        raise FileNotFoundError('File is not found at "{}"'.format(path))
    try:
        payload = torch.load(path, map_location='cpu', weights_only=True)
    except (RuntimeError, pickle.UnpicklingError, EOFError) as e:
        raise ValueError('{} is not a bpbreid_tpu_torch checkpoint ({}); a '
                         'JAX .ckpt does not load into the port'.format(
                             path, e)) from e
    if not (isinstance(payload, dict) and payload.get('format') == FORMAT):
        raise NotImplementedError(
            '{} is not a bpbreid_tpu_torch checkpoint: loading torchreid '
            'state dicts is not ported yet (ROADMAP Queue 1 item 5)'.format(
                path))
    meta = {}
    if osp.exists(path + '.meta.json'):
        with open(path + '.meta.json') as f:
            meta = json.load(f)
    return payload, meta


def resume_from_checkpoint(path, model, optimizer=None):
    """Load the model's and the optimizer's state; returns
    ``(start_epoch, meta)`` with ``start_epoch = epoch + 1``."""
    print('Loading checkpoint from "{}"'.format(path))
    payload, meta = load_checkpoint(path)
    model.load_state_dict(payload['model'])
    if optimizer is not None and payload['optimizer'] is not None:
        optimizer.load_state_dict(payload['optimizer'])
    start_epoch = int(meta.get('epoch', -1)) + 1
    print('Last epoch = {}'.format(start_epoch))
    if meta.get('rank1') is not None:
        print('Last rank1 = {:.1%}'.format(float(meta['rank1'])))
    return start_epoch, meta
