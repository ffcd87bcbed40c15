"""Part-based engine: the train step and the eval path (port of
bpbreid_tpu/engine/part_based.py).

``forward_backward``: augment -> forward in train mode -> GiLt + BPA
losses -> backward -> open-layers gradient masking while the base is
frozen -> optimizer step; the BN running statistics are updated by the
forward (``_train_step_impl`` :196, ``_loss_fn`` :173).

``eval_step``: preprocess -> forward -> the configured test embedding
streams concatenated to ``[N, P+2, D]`` + visibility + pixel-accuracy
counts (``_eval_step_impl`` :284). ``evaluate``: features of the query
and gallery loaders, L2-normalize, visibility-masked part distance and
CMC/mAP on the host (the small-gallery branch of ``_evaluate`` :609).

A loader is any iterable of batch dicts holding numpy arrays: ``image``
``[B, H, W, 3]`` uint8, optional ``mask`` ``[B, h, w, C]`` float
confidence fields, ``pid``, ``camid`` and optional ``valid`` (bool,
padding rows False). Batches are processed one after another on
``device``; features stay on the device until the distance matrix is
read back for ranking.
"""
import numpy as np
import torch

from bpbreid_tpu_torch import resolve_device
from bpbreid_tpu_torch.constants import PIXELS, bn_correspondants
from bpbreid_tpu_torch.data.augment import (IMAGENET_MEAN, IMAGENET_STD,
                                            eval_preprocess,
                                            sample_train_draws, train_augment)
from bpbreid_tpu_torch.losses.bpa import BodyPartAttentionLoss
from bpbreid_tpu_torch.losses.gilt import GiLtLoss
from bpbreid_tpu_torch.metrics.distance import \
    compute_distance_matrix_using_bp_features
from bpbreid_tpu_torch.metrics.rank import evaluate_rank
from bpbreid_tpu_torch.ops.resize import resize_bilinear_align_corners

__all__ = ['ImagePartBasedEngine', 'normalize']


def normalize(features, dim=-1):
    """L2-normalize along ``dim`` in f32 (engine/engine.py:352)."""
    f = features.float()
    return f / f.norm(dim=dim, keepdim=True).clamp(min=1e-12)


class ImagePartBasedEngine:
    """Part-based engine.

    Args:
        model: a ported ``BPBreID`` on ``device``.
        optimizer: a ``torch.optim`` optimizer over ``model``'s parameters
            (``optim.build_optimizer``), or None for an eval-only engine.
        scheduler: an ``optim.LRSchedule``, or None.
        test_embeddings: embedding stream keys (``config.model.bpbreid
            .test_embeddings``).
        mask_kwargs: mask-chain parameters
            (``data.augment.mask_chain_kwargs``), or None without masks.
        losses_weights: GiLt + BPA weights (``config.loss.part_based
            .weights``); None gives the defaults.
        transforms, cj: train-time augmentations and the colour-jitter
            settings (``config.data.transforms``, ``config.data.cj``).
        open_layers: names whose parameters train while the base is
            frozen (``set_freeze_base``).
        seed: seed of the engine's ``torch.Generator`` for the
            augmentation draws.
        device: torch device; ``None`` means ``'cuda'``.
    """

    def __init__(self, model, optimizer=None, scheduler=None,
                 test_embeddings=('bn_foreg', 'parts'),
                 mask_kwargs=None, norm_mean=IMAGENET_MEAN,
                 norm_std=IMAGENET_STD, mask_filtering_testing=True,
                 testing_binary_visibility_score=True,
                 dist_combine_strat='mean',
                 batch_size_pairwise_dist_matrix=500, losses_weights=None,
                 margin=0.3, loss_name='part_averaged_triplet_loss',
                 mask_filtering_training=False, ppl='cl',
                 transforms=('rc', 're'), cj=None, open_layers=('classifier',),
                 seed=0, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        weights = losses_weights or {**GiLtLoss.default_losses_weights,
                                     PIXELS: {'ce': 0.35}}
        self.losses_weights = weights
        self.GiLt = GiLtLoss(weights,
                             use_visibility_scores=mask_filtering_training,
                             triplet_margin=margin, loss_name=loss_name)
        self.body_part_attention_loss = BodyPartAttentionLoss(loss_type=ppl)
        self.transforms = tuple(transforms)
        self.cj = dict(cj or {})
        self.open_layers = list(open_layers or [])
        self._freeze_base = False
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.test_embeddings = list(test_embeddings)
        self.mask_kwargs = mask_kwargs
        self.norm_mean = tuple(norm_mean)
        self.norm_std = tuple(norm_std)
        self.mask_filtering_testing = mask_filtering_testing
        self.testing_binary_visibility_score = testing_binary_visibility_score
        self.dist_combine_strat = dist_combine_strat
        self.batch_size_pairwise_dist_matrix = batch_size_pairwise_dist_matrix

    @classmethod
    def from_config(cls, config, model, mask_kwargs=None, device=None,
                    optimizer=None, scheduler=None):
        cj = config.data.cj
        return cls(model, optimizer=optimizer, scheduler=scheduler,
                   test_embeddings=config.model.bpbreid.test_embeddings,
                   mask_kwargs=mask_kwargs,
                   norm_mean=config.data.norm_mean,
                   norm_std=config.data.norm_std,
                   mask_filtering_testing=(
                       config.model.bpbreid.mask_filtering_testing),
                   testing_binary_visibility_score=(
                       config.model.bpbreid.testing_binary_visibility_score),
                   dist_combine_strat=(
                       config.test.part_based.dist_combine_strat),
                   batch_size_pairwise_dist_matrix=(
                       config.test.batch_size_pairwise_dist_matrix),
                   losses_weights=config.loss.part_based.weights,
                   margin=config.loss.triplet.margin,
                   loss_name=config.loss.part_based.name,
                   mask_filtering_training=(
                       config.model.bpbreid.mask_filtering_training),
                   ppl=config.loss.part_based.ppl,
                   transforms=config.data.transforms,
                   cj={'cj_brightness': cj.brightness,
                       'cj_contrast': cj.contrast,
                       'cj_saturation': cj.saturation, 'cj_hue': cj.hue,
                       'cj_p': cj.p},
                   open_layers=config.train.open_layers,
                   seed=config.train.seed, device=device)

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------
    def set_freeze_base(self, freeze):
        """While frozen, only parameters named by ``open_layers`` get
        their gradient; the others get zeros (the optimizer still
        applies weight decay to them, as the JAX step does)."""
        self._freeze_base = bool(freeze)

    def apply_lr(self, epoch):
        """Set the optimizer's learning rate for ``epoch``."""
        if self.scheduler is not None and self.optimizer is not None:
            self.scheduler.set_in_optimizer(self.optimizer, epoch)

    def loss_fn(self, outputs, masks, pids):
        """GiLt + bpa_w * BPA of the train-mode model outputs; the BPA
        target is the grouped masks resized to the pixel logits' grid
        (align-corners bilinear) and taken by argmax."""
        (embeddings, visibility, id_cls_scores, pixels_cls_scores,
         _spatial, _masks) = outputs
        loss, summary = self.GiLt(embeddings, visibility, id_cls_scores,
                                  pids, generator=self.generator)
        bpa_w = float(self.losses_weights[PIXELS]['ce'])
        if pixels_cls_scores is not None and masks is not None and bpa_w > 0:
            hf, wf = pixels_cls_scores.shape[-2:]
            target = resize_bilinear_align_corners(masks, hf, wf)
            bpa_loss, bpa_summary = self.body_part_attention_loss(
                pixels_cls_scores, target.argmax(dim=1))
            loss = loss + bpa_w * bpa_loss
            summary = {**summary, **bpa_summary}
        return loss, summary

    def forward_backward(self, batch, draws=None):
        """One train step on ``batch`` (``image`` ``[B, H, W, 3]`` uint8,
        optional ``mask`` ``[B, h, w, C]``, ``pid`` ``[B]``; numpy or
        tensors). ``draws`` are the augmentation draws
        (``data.augment.sample_train_draws``), taken from the engine's
        generator when None. Returns ``(loss, summary)`` as tensors on
        the device (no host sync)."""
        if self.optimizer is None:
            raise RuntimeError('the engine has no optimizer: build it with '
                               'one to train')
        imgs_u8 = torch.as_tensor(batch['image']).to(self.device)
        raw_masks = torch.as_tensor(batch['mask']).to(self.device) \
            if batch.get('mask') is not None else None
        pids = torch.as_tensor(batch['pid']).to(self.device)
        n, h, w = imgs_u8.shape[:3]
        if draws is None:
            draws = sample_train_draws(self.generator, n, h, w,
                                       self.transforms, **self.cj)
        imgs, masks = train_augment(imgs_u8, raw_masks, draws,
                                    norm_mean=self.norm_mean,
                                    norm_std=self.norm_std,
                                    mask_kwargs=self.mask_kwargs)
        self.model.train()
        loss, summary = self.loss_fn(self.model(imgs, masks), masks, pids)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        for name, p in self.model.named_parameters():
            if p.grad is None:
                # no path to the loss: a zero gradient, as JAX gives, so
                # the optimizer's weight decay and moments still apply
                p.grad = torch.zeros_like(p)
            elif self._freeze_base and not any(ol in name
                                               for ol in self.open_layers):
                p.grad.zero_()
        self.optimizer.step()
        return loss.detach(), summary

    @torch.inference_mode()
    def eval_step(self, imgs_u8, raw_masks=None):
        """One eval batch on the device.

        Returns ``(features [N, P+2, D], visibility [N, P+2] f32,
        embedding masks [N, P+2, Hf, Wf], pixels_cls_scores, masks,
        pxl_correct [N], pxl_total [N])``.
        """
        self.model.eval()
        imgs, masks = eval_preprocess(imgs_u8, raw_masks,
                                      norm_mean=self.norm_mean,
                                      norm_std=self.norm_std,
                                      mask_kwargs=self.mask_kwargs)
        outputs = self.model(imgs, masks)
        features, visibility, parts_masks, pixels_cls_scores = \
            self.extract_test_embeddings(outputs)
        # pixel part-prediction accuracy vs the target masks
        pxl_correct = pxl_total = torch.zeros((), device=imgs.device)
        if pixels_cls_scores is not None and masks is not None:
            hf, wf = pixels_cls_scores.shape[-2:]
            target = resize_bilinear_align_corners(masks, hf, wf)
            target_idx = target.argmax(dim=1)
            pred_idx = pixels_cls_scores.argmax(dim=1)
            pxl_correct = (pred_idx == target_idx).float().sum(dim=(1, 2))
            pxl_total = torch.full((imgs.shape[0],), float(hf * wf),
                                   device=imgs.device)
        return (features, visibility, parts_masks, pixels_cls_scores, masks,
                pxl_correct, pxl_total)

    def extract_test_embeddings(self, model_output):
        """Concatenate the configured embedding streams to [N, P+2, D]."""
        (embeddings, visibility_scores, _id_cls, pixels_cls_scores,
         _spatial, masks) = model_output
        emb_list, vis_list, mask_list = [], [], []
        for key in self.test_embeddings:
            e = embeddings[key]
            emb_list.append(e if e.dim() == 3 else e[:, None, :])
            raw = bn_correspondants.get(key, key)
            v = visibility_scores[raw]
            vis_list.append(v if v.dim() == 2 else v[:, None])
            m = masks[raw]
            mask_list.append(m if m.dim() == 4 else m[:, None])
        features = torch.cat(emb_list, dim=1)
        visibility = torch.cat([v.float() for v in vis_list], dim=1)
        emb_masks = torch.cat(mask_list, dim=1)
        return features, visibility, emb_masks, pixels_cls_scores

    def feature_extraction(self, loader):
        """Features of every valid sample of ``loader``.

        Returns ``(features [N, P+2, D], visibility [N, P+2])`` on the
        device, ``(pids, camids)`` numpy and the pixel accuracy.
        """
        f_, vis_, pids_, camids_ = [], [], [], []
        pxl_correct = pxl_total = 0.0
        for batch in loader:
            imgs = torch.as_tensor(batch['image']).to(self.device)
            masks = torch.as_tensor(batch['mask']).to(self.device) \
                if batch.get('mask') is not None else None
            valid = np.asarray(batch.get(
                'valid', np.ones(len(batch['pid']), bool)), bool)
            feats, vis, _m, _pxl, _masks, corr, tot = self.eval_step(imgs,
                                                                     masks)
            keep = torch.as_tensor(valid, device=self.device)
            f_.append(feats[keep])
            vis_.append(vis[keep])
            pids_.append(np.asarray(batch['pid'])[valid])
            camids_.append(np.asarray(batch['camid'])[valid])
            if corr.dim():
                pxl_correct += float(corr[keep].sum())
                pxl_total += float(tot[keep].sum())
        acc = pxl_correct / pxl_total if pxl_total else 0.0
        return (torch.cat(f_), torch.cat(vis_), np.concatenate(pids_),
                np.concatenate(camids_), acc)

    def evaluate(self, query_loader, gallery_loader, normalize_feature=True,
                 dist_metric='euclidean', max_rank=50):
        """Query-gallery retrieval: returns ``{'cmc', 'mAP',
        'pixel_accuracy', 'distmat'}`` (numpy / floats)."""
        qf, q_vis, q_pids, q_camids, q_acc = \
            self.feature_extraction(query_loader)
        gf, g_vis, g_pids, g_camids, g_acc = \
            self.feature_extraction(gallery_loader)
        n_q, n_g = len(q_pids), len(g_pids)
        pxl_acc = (q_acc * n_q + g_acc * n_g) / (n_q + n_g) \
            if (n_q + n_g) else 0.0
        if normalize_feature:
            qf, gf = normalize(qf), normalize(gf)
        q_vis_arr = q_vis if self.mask_filtering_testing else None
        g_vis_arr = g_vis if self.mask_filtering_testing else None
        if q_vis_arr is not None and self.testing_binary_visibility_score:
            q_vis_arr, g_vis_arr = q_vis_arr.bool(), g_vis_arr.bool()
        distmat, _ = compute_distance_matrix_using_bp_features(
            qf, gf, q_vis_arr, g_vis_arr, self.dist_combine_strat,
            self.batch_size_pairwise_dist_matrix, metric=dist_metric)
        distmat = distmat.cpu().numpy()
        metrics = evaluate_rank(distmat, q_pids, g_pids, q_camids, g_camids,
                                max_rank=max_rank)
        return {'cmc': metrics['cmc'], 'mAP': metrics['mAP'],
                'pixel_accuracy': pxl_acc, 'distmat': distmat}
