"""Video softmax engine (port of bpbreid_tpu/engine/video/softmax.py).

The image softmax engine on tracklets: a train batch ``[B, S, H, W, 3]``
is flattened to ``[B*S, H, W, 3]`` (B-major, S fastest) with each pid
repeated once per frame, so each frame is augmented on its own, as in
JAX (torchreid draws one transform per tracklet). At eval the frame
embeddings of a tracklet are pooled over S (``pooling_method`` 'avg' or
'max') on the device. ``forward_backward_multi`` flattens step-stacked
tracklets ``[k, B, S, ...]`` to ``[k, B*S, ...]`` and runs the image
engine's k steps (JAX :35-44); the eval batches are grouped by
``test.batches_per_dispatch`` and replay a graph of the frames' forward
and the pooling, as the image engines' (JAX's video eval runs a batch a
dispatch).
"""
import numpy as np
import torch

from bpbreid_tpu_torch.engine.engine import valid_rows
from bpbreid_tpu_torch.engine.image.softmax import ImageSoftmaxEngine

__all__ = ['VideoSoftmaxEngine', 'TrackletEngine', 'flatten_tracklets']


def flatten_tracklets(batch, axis=0):
    """``batch`` with ``image`` ``[..., B, S, ...]`` (``B`` at ``axis``)
    -> ``[..., B*S, ...]`` and ``pid`` repeated S times each along
    ``axis`` (numpy or tensors)."""
    imgs = batch['image']
    b, s = imgs.shape[axis:axis + 2]
    flat = dict(batch)
    flat['image'] = imgs.reshape(*imgs.shape[:axis], b * s,
                                 *imgs.shape[axis + 2:])
    pid = batch['pid']
    flat['pid'] = pid.repeat_interleave(s, dim=axis) \
        if isinstance(pid, torch.Tensor) \
        else np.repeat(np.asarray(pid), s, axis=axis)
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

    def _frames(self, batch, axis):
        """``flatten_tracklets`` at ``axis``. Under a mesh each rank takes
        whole tracklets: its share of the B-major frames is its
        tracklets' frames, so the mesh must divide B."""
        b = batch['image'].shape[axis]
        if self.mesh is not None and b % self.mesh.size:
            raise ValueError('{} tracklets do not split over a {}-rank '
                             'mesh'.format(b, self.mesh.size))
        return flatten_tracklets(batch, axis)

    def forward_backward(self, batch, draws=None):
        """One train step on tracklets (``image`` ``[B, S, H, W, 3]``);
        ``draws`` are for the ``B*S`` frames."""
        return super().forward_backward(self._frames(batch, 0), draws)

    def forward_backward_multi(self, batch, draws=None):
        """k train steps on step-stacked tracklets ``[k, B, S, H, W, 3]``:
        the image engine's on ``[k, B*S, H, W, 3]`` with each pid repeated
        per frame (JAX :35-44); ``draws`` are for the frames."""
        return super().forward_backward_multi(self._frames(batch, 1), draws)

    @torch.inference_mode()
    def tracklet_embeddings(self, imgs_u8):
        """``[B, D]`` f32 embeddings of tracklets ``[B, S, H, W, 3]``:
        ``eval_step`` of the ``[B*S]`` frames, then the mean or the max
        over S."""
        b, s = imgs_u8.shape[:2]
        feats = self.eval_step(imgs_u8.reshape(b * s, *imgs_u8.shape[2:]))
        feats = feats.float().reshape(b, s, -1)
        return feats.mean(dim=1) if self.pooling_method == 'avg' \
            else feats.amax(dim=1)

    def feature_extraction(self, loader):
        """Tracklet embeddings (``tracklet_embeddings``) of every valid
        sample of ``loader`` on the device, grouped by
        ``batches_per_dispatch`` as the image engines'; with the ``pids``
        and ``camids`` (numpy)."""
        f_, pids_, camids_ = [], [], []
        for batch, feats in self._eval_batches(loader,
                                               self.tracklet_embeddings):
            valid = batch['valid']
            f_.append(valid_rows(feats, valid))
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
