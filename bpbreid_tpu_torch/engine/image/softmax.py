"""Global-embedding softmax engine (port of
bpbreid_tpu/engine/image/softmax.py).

Trains a backbone of the model zoo (``osnet_*``, ``resnet50_ibn_*``,
``resnet50mid``, the ResNets) with label-smoothed cross entropy on its
class scores; tests it on its global embedding with the standard
distance matrix.

``forward_backward``: the train augmentation without masks -> the
model in train mode -> ``compute_loss`` -> backward -> the frozen-base
gradient mask while ``fixbase_epoch`` lasts (``train.open_layers``) ->
optimizer step (``_train_step_impl`` :106). ``eval_step``: the test
preprocessing and the model in eval mode, giving the ``[N, D]``
embedding (:173). ``_evaluate`` (:231): the features of the query and
gallery loaders on the device, optional L2 normalization, the distance
matrix, optional k-reciprocal re-ranking (on the host, as in JAX),
CMC/mAP (the CUHK03 metric with ``use_metric_cuhk03``) and the SSMD of
the pair distances. ``save_model`` writes the port's checkpoints
(``utils/checkpoint.py``). JAX's grouped dispatch
(``_train_multi_step_impl``, ``_eval_multi_step_impl``,
``_drain_group``) is left out, as in the part-based engine.
"""
import numpy as np
import torch

from bpbreid_tpu_torch import resolve_device
from bpbreid_tpu_torch.data.augment import (eval_preprocess,
                                            sample_train_draws, train_augment)
from bpbreid_tpu_torch.engine.engine import (Engine, device_prefetch,
                                             normalize)
from bpbreid_tpu_torch.losses.cross_entropy import CrossEntropyLoss
from bpbreid_tpu_torch.metrics.distance import compute_distance_matrix
from bpbreid_tpu_torch.metrics.rank import evaluate_rank
from bpbreid_tpu_torch.utils.distribution import \
    plot_pairs_distance_distribution
from bpbreid_tpu_torch.utils.rerank import re_ranking

__all__ = ['ImageSoftmaxEngine']


class ImageSoftmaxEngine(Engine):
    """Args:
        datamanager: gives ``transforms``, ``norm_mean``, ``norm_std``
            and, for ``run``, the loaders.
        model: a ported zoo model on ``device`` (``models.build_model``).
        optimizer: a ``torch.optim`` optimizer over ``model``'s
            parameters, or None for an eval-only engine.
        scheduler: an ``optim.LRSchedule``, or None.
        label_smooth: label smoothing (eps 0.1) in the cross entropy.
        config: gives the colour-jitter settings (``data.cj``),
            ``train.open_layers``, ``train.seed`` (the engine's
            ``torch.Generator`` for the augmentation draws) and what
            ``run`` needs; None for an engine driven step by step.
        device: torch device; ``None`` means ``'cuda'``.
    """
    loss_mode = 'softmax'
    # the global models take no part masks and have no int8 graph: what
    # the FeatureExtractor reads from an engine
    mask_kwargs = None
    int8_calibrated = False

    def __init__(self, datamanager, model, optimizer=None, scheduler=None,
                 label_smooth=True, config=None, writer=None,
                 engine_state=None, save_model_flag=False, device=None):
        self.device = resolve_device(device)
        super().__init__(config, datamanager, writer, engine_state)
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.save_model_flag = save_model_flag
        self.criterion = CrossEntropyLoss(label_smooth=label_smooth)
        self.transforms = tuple(datamanager.transforms)
        self.norm_mean = tuple(datamanager.norm_mean)
        self.norm_std = tuple(datamanager.norm_std)
        self.cj = {}
        if config is not None:
            cj = config.data.cj
            self.cj = {'cj_brightness': cj.brightness,
                       'cj_contrast': cj.contrast,
                       'cj_saturation': cj.saturation, 'cj_hue': cj.hue,
                       'cj_p': cj.p}
            self.open_layers = list(config.train.open_layers)
        seed = config.train.seed if config is not None else 0
        self.generator = torch.Generator(self.device).manual_seed(seed)

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------
    def compute_loss(self, outputs, pids):
        """Label-smoothed CE of the class scores, and the top-1
        accuracy (``_compute_loss`` :101)."""
        loss = self.criterion(outputs, pids)
        acc = (outputs.argmax(dim=-1) == pids).float().mean()
        return loss, {'softmax': {'loss': loss.detach(), 'acc': acc}}

    def forward_backward(self, batch, draws=None):
        """One train step on ``batch`` (``image`` ``[B, H, W, 3]`` uint8,
        ``pid`` ``[B]``; numpy or tensors). ``draws`` are the augmentation
        draws (``data.augment.sample_train_draws``), taken from the
        engine's generator when None. Returns ``(loss, summary)`` as
        tensors on the device (no host sync)."""
        self.require_optimizer()
        imgs_u8 = torch.as_tensor(batch['image']).to(self.device)
        pids = torch.as_tensor(batch['pid']).to(self.device)
        n, h, w = imgs_u8.shape[:3]
        if draws is None:
            draws = sample_train_draws(self.generator, n, h, w,
                                       self.transforms, **self.cj)
        imgs, _ = train_augment(imgs_u8, None, draws,
                                norm_mean=self.norm_mean,
                                norm_std=self.norm_std)
        self.model.train()
        loss, summary = self.compute_loss(self.model(imgs), pids)
        self.optimizer_step(loss)
        return loss.detach(), summary

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def eval_step(self, imgs_u8):
        """``[N, D]`` embeddings of a ``[N, H, W, 3]`` uint8 batch on the
        device (``_eval_step_impl`` :173)."""
        self.model.eval()
        imgs, _ = eval_preprocess(torch.as_tensor(imgs_u8).to(self.device),
                                  norm_mean=self.norm_mean,
                                  norm_std=self.norm_std)
        return self.model(imgs)

    def feature_extraction(self, loader):
        """Embeddings of every valid sample of ``loader`` on the device,
        with their ``pids`` and ``camids`` (numpy; ``_feature_extraction``
        :209)."""
        f_, pids_, camids_ = [], [], []
        for batch in device_prefetch(loader, self.device, keys=('image',)):
            valid = np.asarray(batch.get(
                'valid', np.ones(len(batch['pid']), bool)), bool)
            feats = self.eval_step(batch['image'])
            f_.append(feats[torch.as_tensor(valid, device=self.device)])
            pids_.append(np.asarray(batch['pid'])[valid])
            camids_.append(np.asarray(batch['camid'])[valid])
        return torch.cat(f_), np.concatenate(pids_), np.concatenate(camids_)

    def _evaluate(self, epoch, dataset_name='', query_loader=None,
                  gallery_loader=None, dist_metric='euclidean',
                  normalize_feature=False, use_metric_cuhk03=False,
                  ranks=(1, 5, 10, 20), rerank=False, **kwargs):
        """Query-gallery retrieval on the global embeddings (``_evaluate``
        :231); returns ``(cmc, mAP, ssmd, 0.0)`` (no pixel accuracy)."""
        qf, q_pids, q_camids = self.feature_extraction(query_loader)
        gf, g_pids, g_camids = self.feature_extraction(gallery_loader)
        if normalize_feature:
            qf, gf = normalize(qf), normalize(gf)
        distmat = compute_distance_matrix(qf, gf, dist_metric).cpu().numpy()
        if rerank:
            distmat = re_ranking(
                distmat,
                compute_distance_matrix(qf, qf, dist_metric).cpu().numpy(),
                compute_distance_matrix(gf, gf, dist_metric).cpu().numpy())
        result = evaluate_rank(
            distmat, q_pids, g_pids, q_camids, g_camids,
            eval_metric='cuhk03' if use_metric_cuhk03 else 'default')
        cmc, mAP = result['cmc'], result['mAP']
        print('** Results: mAP {:.2%}'.format(mAP))
        for r in ranks:
            if r <= len(cmc):      # tiny galleries: CMC shorter than max_rank
                print('Rank-{:<3}: {:.2%}'.format(r, cmc[r - 1]))
        ssmd = plot_pairs_distance_distribution(distmat, q_pids, g_pids)[-1]
        return cmc, mAP, ssmd, 0.0
