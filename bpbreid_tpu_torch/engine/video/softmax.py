"""Video softmax engine (port of bpbreid_tpu/engine/video/softmax.py).

The image softmax engine on tracklets: a train batch ``[B, S, H, W, 3]``
is flattened to ``[B*S, H, W, 3]`` (B-major, S fastest) with each pid
repeated once per frame, so each frame is augmented on its own, as in
JAX (torchreid draws one transform per tracklet). At eval the frame
embeddings of a tracklet are pooled over S (``pooling_method`` 'avg' or
'max') on the device. JAX's ``forward_backward_multi`` (its grouped TPU
dispatch) is left out, as in the image engines.
"""
import numpy as np
import torch

from bpbreid_tpu_torch.engine.engine import device_prefetch
from bpbreid_tpu_torch.engine.image.softmax import ImageSoftmaxEngine

__all__ = ['VideoSoftmaxEngine', 'TrackletEngine', 'flatten_tracklets']


def flatten_tracklets(batch):
    """``batch`` with ``image`` ``[B, S, ...]`` -> ``[B*S, ...]`` and
    ``pid`` repeated S times each (numpy or tensors)."""
    imgs = batch['image']
    b, s = imgs.shape[:2]
    flat = dict(batch)
    flat['image'] = imgs.reshape(b * s, *imgs.shape[2:])
    pid = batch['pid']
    flat['pid'] = pid.repeat_interleave(s) if isinstance(pid, torch.Tensor) \
        else np.repeat(np.asarray(pid), s)
    return flat


class TrackletEngine:
    """Mixed in ahead of an image engine: its train step on the flattened
    frames, its embeddings pooled per tracklet. (JAX's triplet engine
    borrows the softmax engine's methods instead, whose zero-argument
    ``super()`` then fails: ROADMAP, "The JAX package at fault".)"""

    def set_pooling_method(self, pooling_method):
        if pooling_method not in ('avg', 'max'):
            raise ValueError("pooling_method must be 'avg' or 'max', got "
                             "{}".format(pooling_method))
        self.pooling_method = pooling_method

    def forward_backward(self, batch, draws=None):
        """One train step on tracklets (``image`` ``[B, S, H, W, 3]``);
        ``draws`` are for the ``B*S`` frames."""
        return super().forward_backward(flatten_tracklets(batch), draws)

    def feature_extraction(self, loader):
        """Tracklet embeddings of every valid sample of ``loader``: the
        ``eval_step`` of its ``[B*S]`` frames, then the mean or the max
        over S in f32 on the device; with the ``pids`` and ``camids``
        (numpy)."""
        f_, pids_, camids_ = [], [], []
        for batch in device_prefetch(loader, self.device, keys=('image',)):
            imgs = batch['image']
            b, s = imgs.shape[:2]
            feats = self.eval_step(imgs.reshape(b * s, *imgs.shape[2:]))
            feats = feats.float().reshape(b, s, -1)
            feats = feats.mean(dim=1) if self.pooling_method == 'avg' \
                else feats.amax(dim=1)
            valid = np.asarray(batch['valid'], bool)
            f_.append(feats[torch.as_tensor(valid, device=feats.device)])
            pids_.append(np.asarray(batch['pid'])[valid])
            camids_.append(np.asarray(batch['camid'])[valid])
        return torch.cat(f_), np.concatenate(pids_), np.concatenate(camids_)


class VideoSoftmaxEngine(TrackletEngine, ImageSoftmaxEngine):
    """Args as ``ImageSoftmaxEngine``'s, and ``pooling_method`` ('avg'
    or 'max')."""

    def __init__(self, datamanager, model, optimizer=None, scheduler=None,
                 label_smooth=True, pooling_method='avg', config=None,
                 writer=None, engine_state=None, save_model_flag=False,
                 device=None):
        super().__init__(datamanager, model, optimizer, scheduler=scheduler,
                         label_smooth=label_smooth, config=config,
                         writer=writer, engine_state=engine_state,
                         save_model_flag=save_model_flag, device=device)
        self.set_pooling_method(pooling_method)
