"""Part-based engine: the train step and the eval path (port of
bpbreid_tpu/engine/part_based.py).

``forward_backward``: augment -> forward in train mode -> GiLt + BPA
losses -> backward -> open-layers gradient masking while the base is
frozen -> optimizer step; the BN running statistics are updated by the
forward (``_train_step_impl`` :196, ``_loss_fn`` :173).

``eval_step``: preprocess -> forward -> the configured test embedding
streams concatenated to ``[N, P+2, D]`` + visibility + pixel-accuracy
counts (``_eval_step_impl`` :284); with ``quant_opts``, the forward runs
the calibrated int8 graph (``ops/quant.py``). With ``test.int8`` in the
config, ``feature_extraction`` first calibrates the activation ranges on
the first ``test.int8_calib_batches`` batches of the first loader it
evaluates (the query loader; ``_calibrate_int8`` :422), keeps them for
every later loader, and extracts with the int8 graph (:468-498,
:577-584). ``forward_backward_multi`` (``engine/engine.py``) runs k
stacked steps, and ``feature_extraction`` goes in groups of
``test.batches_per_dispatch`` batches, JAX's grouped dispatch (:262,
:491-590), through CUDA graphs of the train and eval steps on the card.
``evaluate`` (``_evaluate`` :609): features of the query and gallery
loaders, L2-normalize, then either
the visibility-masked part distance on the device, optional
k-reciprocal re-ranking and CMC/mAP on the host, or, once
``Nq * Ng`` exceeds ``device_ranking_threshold`` (and without
re-ranking), the query-chunked device pipeline
(``_chunked_device_eval`` :818): per chunk the part distances, the
sort-free counting ranker (``ops/ranking.py``) and the pair-distance
moments of an exact SSMD, all on the device. With ``detailed_ranking``
on, each part's mAP and rank-1 are reported too; with a writer, the
query-gallery distance statistics (``utils/writer.py``); with
``visrank``, the ranking grids (``utils/visualization/rankings.py``),
whose attention maps come from ``eval_step`` run again on the selected
samples (``_evaluate`` :747-789); with ``embeddings_dir``, the query and
gallery embeddings' projection (``utils/visualization/embeddings.py``,
``test.vis_embedding_projection`` in ``_evaluate``, JAX :805-812).
With ``train.batch_debug_freq`` in the config, ``forward_backward``
draws the debug figures of every that many steps
(``_debug_visualize_batch``, JAX :382-420).

A loader is any iterable of batch dicts holding numpy arrays: ``image``
``[B, H, W, 3]`` uint8, optional ``mask`` ``[B, h, w, C]`` float
confidence fields, ``pid``, ``camid`` and optional ``valid`` (bool,
padding rows False). Batches go to ``device`` through
``engine.device_prefetch``; features stay on the device until the
distance matrix is read back for ranking.

Under ``parallel.distribute_engine`` (JAX's mesh branches, :372-377,
:577-580, :678-690, :889-896) ``forward_backward`` takes the global
batch's draws, runs the model on this rank's slice and computes the
GiLt + BPA loss over the gathered outputs (its own slice live);
``eval_step`` splits a batch over the ranks when the world size divides
it (else every rank runs it whole) and gathers its outputs; the
query-gallery distances split the gallery columns
(``parallel.sharded_bp_distance``). Rank 0 alone draws the figures and
writes the features.

As an ``Engine`` (``engine/engine.py``) built with a config and a data
manager, ``run`` trains and tests it (``_evaluate`` :609 over the data
manager's loaders) and ``save_model`` (:149) writes the port's
checkpoints (``utils/checkpoint.py``).
"""
import os
import os.path as osp

import numpy as np
import torch

from bpbreid_tpu_torch import resolve_device
from bpbreid_tpu_torch.constants import (PARTS, PIXELS, bn_correspondants,
                                         get_test_embeddings_names)
from bpbreid_tpu_torch.data.augment import (IMAGENET_MEAN, IMAGENET_STD,
                                            eval_preprocess,
                                            sample_train_draws, slice_draws,
                                            train_augment)
from bpbreid_tpu_torch.engine.engine import Engine, normalize, valid_rows
from bpbreid_tpu_torch.losses.bpa import BodyPartAttentionLoss
from bpbreid_tpu_torch.losses.gilt import GiLtLoss
from bpbreid_tpu_torch.metrics.distance import \
    compute_distance_matrix_using_bp_features
from bpbreid_tpu_torch.metrics.rank import evaluate_rank
from bpbreid_tpu_torch.models.bpbreid import set_dropout_generator
from bpbreid_tpu_torch.ops.quant import (QuantOpts, clear_calibration,
                                         int8_calibration)
from bpbreid_tpu_torch.ops.ranking import cmc_map, cmc_map_counting
from bpbreid_tpu_torch.ops.resize import resize_bilinear_align_corners
from bpbreid_tpu_torch.parallel.mesh import all_gather, gather_tree
from bpbreid_tpu_torch.parallel.retrieval import sharded_bp_distance
from bpbreid_tpu_torch.utils.distribution import (
    compute_ssmd, plot_pairs_distance_distribution)
from bpbreid_tpu_torch.utils.rerank import re_ranking
from bpbreid_tpu_torch.utils.tracing import span
from bpbreid_tpu_torch.utils.visualization.batch_triplets import \
    display_batch_triplets
from bpbreid_tpu_torch.utils.visualization.embeddings import \
    visualize_embeddings_projection
from bpbreid_tpu_torch.utils.visualization.feature_maps import \
    display_feature_maps
from bpbreid_tpu_torch.utils.visualization.rankings import \
    visualize_ranking_grid

__all__ = ['ImagePartBasedEngine', 'normalize']


class ImagePartBasedEngine(Engine):
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
        detailed_ranking: also rank each test embedding stream alone
            (``config.test.detailed_ranking``); ``parts_names`` name the
            part streams in that table.
        seed: seed of the engine's ``torch.Generator`` for the
            augmentation draws.
        device: torch device; ``None`` means ``'cuda'``.
        config, datamanager, writer, engine_state: what ``run`` needs
            (``Engine``); None for an engine driven step by step.
        save_model_flag: write a checkpoint after each test of ``run``.
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
                 detailed_ranking=False, parts_names=(), seed=0, device=None,
                 config=None, datamanager=None, writer=None,
                 engine_state=None, save_model_flag=False):
        self.device = resolve_device(device)
        super().__init__(config, datamanager, writer, engine_state)
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.save_model_flag = save_model_flag
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
        self.generator = torch.Generator(self.device).manual_seed(seed)
        # the after-pooling dropout draws its masks from this generator
        set_dropout_generator(model, self.generator)
        self.test_embeddings = list(test_embeddings)
        self.mask_kwargs = mask_kwargs
        self.norm_mean = tuple(norm_mean)
        self.norm_std = tuple(norm_std)
        self.mask_filtering_testing = mask_filtering_testing
        self.testing_binary_visibility_score = testing_binary_visibility_score
        self.dist_combine_strat = dist_combine_strat
        self.batch_size_pairwise_dist_matrix = batch_size_pairwise_dist_matrix
        self.detailed_ranking = detailed_ranking
        self.parts_names = list(parts_names)
        # above Nq * Ng of this, evaluate takes the query-chunked path
        self.device_ranking_threshold = int(2e8)
        # cfg.test.int8: the model's activation ranges, recorded once on
        # the first loader evaluated
        self.int8_calibrated = False
        # the QuantOpts feature extraction's step runs under
        self._eval_quant_opts = None

    @classmethod
    def from_config(cls, config, model, mask_kwargs=None, device=None,
                    optimizer=None, scheduler=None, datamanager=None,
                    writer=None, engine_state=None, save_model_flag=False):
        """The engine ``config`` describes; without ``mask_kwargs`` those
        of ``datamanager``, when one is given."""
        cj = config.data.cj
        if mask_kwargs is None and datamanager is not None:
            mask_kwargs = datamanager.mask_chain_kwargs()
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
                   detailed_ranking=config.test.detailed_ranking,
                   parts_names=config.model.bpbreid.masks.parts_names,
                   seed=config.train.seed, device=device, config=config,
                   datamanager=datamanager, writer=writer,
                   engine_state=engine_state,
                   save_model_flag=save_model_flag)

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------
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
        generator when None. Under a mesh ``batch`` and ``draws`` are the
        global batch's: the model runs on this rank's slice and the loss
        on the gathered outputs. Returns ``(loss, summary)`` as tensors on
        the device (no host sync)."""
        self.require_optimizer()
        with span('engine.train_inputs'):
            inputs = self.train_inputs(batch)
        loss, summary = self.train_step(*inputs, draws=draws)
        freq = self.config.train.batch_debug_freq \
            if self.config is not None else 0
        if freq and self.engine_state.global_step % freq == 0 \
                and self.writes:
            self._debug_visualize_batch(batch)
        return loss, summary

    def train_inputs(self, batch):
        """``(image, mask or None, pid)`` of ``batch`` on the device."""
        return (torch.as_tensor(batch['image']).to(self.device),
                torch.as_tensor(batch['mask']).to(self.device)
                if batch.get('mask') is not None else None,
                torch.as_tensor(batch['pid']).to(self.device))

    def train_step(self, imgs_u8, raw_masks, pids, draws=None):
        """The train step on device tensors (``forward_backward``'s, and
        what the train graph captures): augmentation (its draws from the
        engine's generator when ``draws`` is None), the forward in train
        mode, GiLt + BPA, backward and the optimizer's step. Returns
        ``(loss, summary)`` on the device. Under a profiler its eager
        calls are the spans ``engine.forward`` (augmentation and the
        model), ``engine.loss``, ``engine.backward`` and
        ``engine.optimizer``; a graph's replay runs none of them."""
        n, h, w = imgs_u8.shape[:3]
        if draws is None:
            draws = sample_train_draws(self.generator, n, h, w,
                                       self.transforms, **self.cj)
        if self.mesh is not None:
            lo, hi = self.shard(n)
            imgs_u8, draws = imgs_u8[lo:hi], slice_draws(draws, lo, hi)
            raw_masks = raw_masks[lo:hi] if raw_masks is not None else None
        with span('engine.forward'):
            imgs, masks = train_augment(imgs_u8, raw_masks, draws,
                                        norm_mean=self.norm_mean,
                                        norm_std=self.norm_std,
                                        mask_kwargs=self.mask_kwargs)
            self.model.train()
            outputs = self.model(imgs, masks)
        with span('engine.loss'):
            if self.mesh is not None:
                # what the loss reads, over the global batch
                outputs = tuple(gather_tree(outputs[:4], self.mesh)) + (
                    None, None)
                masks = all_gather(masks, self.mesh) \
                    if masks is not None else None
            loss, summary = self.loss_fn(outputs, masks, pids)
        self.optimizer_step(loss)
        return loss.detach(), summary

    def _debug_visualize_batch(self, batch, max_samples=4):
        """The debug figures of a training batch (JAX :391-420): an
        eval-mode forward of the whole batch on the device, then the PCA
        feature maps and part argmaxes of its first ``max_samples``
        samples into ``<save_dir>/debug_feature_maps`` and the batch-hard
        triplets of its ``parts`` embeddings into
        ``<save_dir>/debug_triplets``. With multires pooling the forward
        also builds the concatenated map that it otherwise skips
        (``materialize_spatial``). The model is put back in train mode.
        Unlike JAX, a failure raises. Returns the figures' paths."""
        imgs_u8 = torch.as_tensor(batch['image']).to(self.device)
        raw_masks = torch.as_tensor(batch['mask']).to(self.device) \
            if batch.get('mask') is not None else None
        self.model.eval()
        try:
            with torch.no_grad():
                imgs, masks = eval_preprocess(imgs_u8, raw_masks,
                                              norm_mean=self.norm_mean,
                                              norm_std=self.norm_std,
                                              mask_kwargs=self.mask_kwargs)
                emb, _vis, _idc, _pix, spatial, out_masks = self.model(
                    imgs, masks, materialize_spatial=True)
        finally:
            self.model.train()
        base_dir = (self.config.data.save_dir
                    if self.config is not None else '.') or '.'
        pids = np.asarray(torch.as_tensor(batch['pid']).cpu())
        paths = display_feature_maps(
            emb, spatial[:max_samples].float().permute(0, 2, 3, 1).cpu()
            .numpy(),
            out_masks[PARTS][:max_samples].float().permute(0, 2, 3, 1).cpu()
            .numpy(),
            batch.get('img_path', [''] * max_samples), pids[:max_samples],
            save_dir=osp.join(base_dir, 'debug_feature_maps'))
        triplets = display_batch_triplets(
            imgs_u8.cpu().numpy(), emb[PARTS].float().cpu().numpy(), pids,
            osp.join(base_dir, 'debug_triplets'))
        return paths + ([triplets] if triplets else [])

    @torch.inference_mode()
    def eval_step(self, imgs_u8, raw_masks=None, quant_opts=None,
                  shard=True):
        """One eval batch on the device; with ``quant_opts`` (a
        ``QuantOpts``) through the calibrated int8 graph. Under a mesh,
        with ``shard``, a batch that the world size divides is split over
        the ranks and the outputs gathered (every rank must call it);
        other batches run whole on every rank.

        Returns ``(features [N, P+2, D], visibility [N, P+2] f32,
        embedding masks [N, P+2, Hf, Wf], pixels_cls_scores, masks,
        pxl_correct [N], pxl_total [N])``.
        """
        n = imgs_u8.shape[0]
        if shard and self.mesh is not None and self.mesh.size > 1 \
                and n % self.mesh.size == 0:
            lo, hi = self.shard(n)
            out = self.eval_step(
                imgs_u8[lo:hi],
                raw_masks[lo:hi] if raw_masks is not None else None,
                quant_opts, shard=False)
            return tuple(gather_tree(t, self.mesh)
                         if isinstance(t, torch.Tensor) and t.dim() else t
                         for t in out)
        self.model.eval()
        imgs, masks = eval_preprocess(imgs_u8, raw_masks,
                                      norm_mean=self.norm_mean,
                                      norm_std=self.norm_std,
                                      mask_kwargs=self.mask_kwargs)
        if quant_opts is None:
            outputs = self.model(imgs, masks)
        else:
            with quant_opts.inference_context():
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

    @torch.inference_mode()
    def calibrate_int8(self, loader, n_batches=4, percentile=99.9):
        """Record the model's activation ranges afresh: the running
        maxima over the first ``n_batches`` batches of ``loader`` of each
        quantization point's ``calib_amax`` at ``percentile``
        (``_calibrate_int8`` :422). The forwards run in float."""
        clear_calibration(self.model)
        self.model.eval()
        with int8_calibration(percentile=percentile):
            for i, batch in enumerate(loader):
                if i >= n_batches:
                    break
                imgs = torch.as_tensor(batch['image']).to(self.device)
                masks = torch.as_tensor(batch['mask']).to(self.device) \
                    if batch.get('mask') is not None else None
                imgs, masks = eval_preprocess(imgs, masks,
                                              norm_mean=self.norm_mean,
                                              norm_std=self.norm_std,
                                              mask_kwargs=self.mask_kwargs)
                self.model(imgs, masks)
        self.int8_calibrated = True

    def int8_quant_opts(self, loader):
        """``QuantOpts`` of ``config.test`` when ``test.int8`` is on,
        calibrating on ``loader`` the first time (``_maybe_int8_eval_step``
        :468); None otherwise."""
        tcfg = getattr(self.config, 'test', None)
        if tcfg is None or not getattr(tcfg, 'int8', False):
            return None
        if not self.int8_calibrated:
            self.calibrate_int8(
                loader, max(1, int(getattr(tcfg, 'int8_calib_batches', 4))),
                float(getattr(tcfg, 'int8_calib_percentile', 99.9)))
        return QuantOpts.from_config(tcfg)

    @torch.inference_mode()
    def _eval_outputs(self, imgs_u8, raw_masks):
        """What feature extraction keeps of ``eval_step`` (features,
        visibility, pixel-accuracy counts), under ``_eval_quant_opts``:
        the function the eval graph captures (JAX's scan body
        ``_eval_multi_step_impl`` :310 returns the same four)."""
        feats, vis, _m, _pxl, _masks, corr, tot = self.eval_step(
            imgs_u8, raw_masks, self._eval_quant_opts)
        return feats, vis, corr, tot

    def feature_extraction(self, loader):
        """Features of every valid sample of ``loader`` (through the int8
        graph with ``test.int8``).

        With ``test.batches_per_dispatch`` k above 1 the batches go in
        groups of k (``_eval_batch_groups``; a padded trailing group's
        all-invalid batches are skipped), and with ``eval_graphs`` each
        batch replays a CUDA graph of ``_eval_outputs``, captured after
        the int8 calibration (JAX :491-590). The valid rows are taken with
        index tensors made from the host's ``valid`` and the pixel counts
        summed on the device (exact in f64), so nothing is read back until
        the pixel accuracy at the end. Under a profiler the call is the
        span ``engine.feature_extraction``, and its tail (the features'
        concatenation and the pixel-accuracy read) ``engine.gather_features``.

        Returns ``(features [N, P+2, D], visibility [N, P+2])`` on the
        device, ``(pids, camids)`` numpy and the pixel accuracy.
        """
        with span('engine.feature_extraction'):
            f_, vis_, pids_, camids_, corr_, tot_ = [], [], [], [], [], []
            quant_opts = self._eval_quant_opts = self.int8_quant_opts(loader)
            for batch, (feats, vis, corr, tot) in self._eval_batches(
                    loader, self._eval_outputs, keys=('image', 'mask'),
                    key=quant_opts):
                valid = batch['valid']
                f_.append(valid_rows(feats, valid))
                vis_.append(valid_rows(vis, valid))
                pids_.append(np.asarray(batch['pid'])[valid])
                camids_.append(np.asarray(batch['camid'])[valid])
                if corr.dim():
                    corr_.append(valid_rows(corr, valid).sum(
                        dtype=torch.float64))
                    tot_.append(valid_rows(tot, valid).sum(
                        dtype=torch.float64))
            with span('engine.gather_features'):
                feats, vis = torch.cat(f_), torch.cat(vis_)
                correct = float(torch.stack(corr_).sum()) if corr_ else 0.0
                total = float(torch.stack(tot_).sum()) if tot_ else 0.0
            return (feats, vis, np.concatenate(pids_),
                    np.concatenate(camids_),
                    correct / total if total else 0.0)

    def evaluate(self, query_loader, gallery_loader, normalize_feature=True,
                 dist_metric='euclidean', max_rank=50, eval_metric='default',
                 use_metric_cuhk03=False, rerank=False, features_dir=None,
                 visrank=False, visrank_topk=10, visrank_q_idx_list=None,
                 visrank_count=10, visrank_dir=None, dataset_name='',
                 embeddings_dir=None):
        """Query-gallery retrieval.

        With ``rerank``, k-reciprocal re-ranking (``utils/rerank.py``, on
        the host) of the distance matrix, from the query-query and
        gallery-gallery distances computed on the device, before CMC, mAP
        and SSMD; the chunked path is then never taken. With
        ``features_dir``, ``features.npz`` is written there (``qf, gf,
        q_vis, g_vis, q_pids, g_pids, q_camids, g_camids``, the features
        as ranked). With a writer, its query-gallery distance statistics
        (before re-ranking, as in JAX). With ``visrank``, a ranking grid
        of ``visrank_topk`` gallery images for each of ``visrank_count``
        queries (``visrank_q_idx_list`` first, then seeded picks) in
        ``visrank_dir``; the loaders must be ``BatchLoader``s (their
        datasets give the thumbnails and the samples ``eval_step`` runs
        again). The chunked path draws none, as in JAX.

        Returns ``{'cmc', 'mAP', 'ssmd', 'pixel_accuracy', 'distmat',
        'parts_ranking'}`` (numpy / floats). ``distmat`` is the whole
        distance matrix on the host path (re-ranked with ``rerank``); on
        the chunked path the first query chunk over a subsample of the
        gallery columns, which CMC, mAP, SSMD and the per-part table do
        not use there: they are exact over the whole run.
        ``parts_ranking`` holds ``(name, mAP %, rank-1 %)`` per stream
        with ``detailed_ranking``, else None; ``visrank_paths`` the
        grids' files.
        """
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
        if use_metric_cuhk03:
            eval_metric = 'cuhk03'

        big_gallery = (n_q * n_g > self.device_ranking_threshold
                       and eval_metric == 'default' and not rerank)
        part_rows = None
        if big_gallery:
            (cmc, mAP, distmat, body_parts_distmat, n_q_host, g_pids_host,
             g_camids_host, part_rows, pair_stats) = \
                self._chunked_device_eval(qf, gf, q_vis_arr, g_vis_arr,
                                          q_pids, g_pids, q_camids, g_camids,
                                          dist_metric, max_rank=max_rank)
            q_pids_host = q_pids[:n_q_host]
            q_camids_host = q_camids[:n_q_host]
            q_vis_host = q_vis[:n_q_host]
        else:
            distmat, body_parts_distmat = self._distances(
                qf, gf, q_vis_arr, g_vis_arr, dist_metric)
            g_pids_host, g_camids_host = g_pids, g_camids
            q_pids_host, q_camids_host, q_vis_host = q_pids, q_camids, q_vis
        if self.writer is not None:
            self.writer.qg_pairwise_dist_statistics(
                distmat, body_parts_distmat, q_vis_host, g_vis,
                subsample=big_gallery)
        if not big_gallery:
            distmat = distmat.cpu().numpy()
            body_parts_distmat = body_parts_distmat.cpu().numpy() \
                if self.detailed_ranking or visrank else None
            if rerank:
                d_qq, d_gg = (compute_distance_matrix_using_bp_features(
                    f, f, v, v, self.dist_combine_strat,
                    self.batch_size_pairwise_dist_matrix,
                    metric=dist_metric)[0].cpu().numpy()
                    for f, v in ((qf, q_vis_arr), (gf, g_vis_arr)))
                distmat = re_ranking(distmat, d_qq, d_gg)
            metrics = evaluate_rank(distmat, q_pids, g_pids, q_camids,
                                    g_camids, max_rank=max_rank,
                                    eval_metric=eval_metric)
            cmc, mAP = metrics['cmc'], metrics['mAP']

        parts_ranking = None
        if self.detailed_ranking:
            parts_ranking = self.display_individual_parts_ranking_performances(
                body_parts_distmat, g_camids_host, g_pids_host,
                q_camids_host, q_pids_host, eval_metric,
                precomputed_rows=part_rows)
        if big_gallery and pair_stats is not None:
            # exact moments of the whole run, accumulated per chunk
            ssmd = compute_ssmd(*pair_stats)
        else:
            ssmd = plot_pairs_distance_distribution(distmat, q_pids_host,
                                                    g_pids_host)[-1]
        visrank_paths = []
        if visrank and big_gallery:
            print('visrank skipped: gallery too large for ranking grids')
        elif visrank and self.writes:
            visrank_paths = self._visrank(
                query_loader, gallery_loader, distmat, body_parts_distmat,
                q_vis.cpu().numpy(), g_vis.cpu().numpy(), mAP,
                float(cmc[0]), visrank_topk, visrank_q_idx_list,
                visrank_count, visrank_dir, dataset_name)
        if features_dir and self.writes:
            os.makedirs(features_dir, exist_ok=True)
            np.savez(osp.join(features_dir, 'features.npz'),
                     qf=qf.float().cpu().numpy(), gf=gf.float().cpu().numpy(),
                     q_vis=q_vis.cpu().numpy(), g_vis=g_vis.cpu().numpy(),
                     q_pids=q_pids, g_pids=g_pids,
                     q_camids=q_camids, g_camids=g_camids)
            print('Saved features to {}'.format(features_dir))
        if embeddings_dir is not None and self.writes:
            visualize_embeddings_projection(
                qf.float().cpu().numpy(), gf.float().cpu().numpy(), q_pids,
                g_pids, embeddings_dir, dataset_name=dataset_name)
        return {'cmc': cmc, 'mAP': mAP, 'ssmd': ssmd,
                'pixel_accuracy': pxl_acc, 'distmat': distmat,
                'parts_ranking': parts_ranking,
                'visrank_paths': visrank_paths}

    def _visrank(self, query_loader, gallery_loader, distmat, bp_distmat,
                 q_vis, g_vis, mAP, rank1, topk, q_idx_list, count, out_dir,
                 dataset_name):
        """The ranking grids of ``evaluate`` (JAX :755-789)."""
        if not out_dir:
            raise ValueError('visrank needs a visrank_dir')
        for loader in (query_loader, gallery_loader):
            if not hasattr(loader, 'dataset'):
                raise ValueError('visrank needs BatchLoaders (their datasets '
                                 'give the thumbnails)')
        pad_to = max(int(topk), 1)

        def masks_for(idxs, kind):
            """``[M, Hf, Wf, P]`` attention maps of the selected samples:
            ``eval_step`` again on a batch padded to ``visrank_topk`` (one
            shape for every call), instead of holding the whole run's
            maps."""
            loader = query_loader if kind == 'query' else gallery_loader
            padded = (list(idxs) + [idxs[0]] * pad_to)[:pad_to]
            samples = [loader.dataset.get(loader.mode, i, loader.height,
                                          loader.width,
                                          mask_grid=loader.mask_grid)
                       for i in padded]
            imgs = torch.as_tensor(np.stack([s['image'] for s in samples]))
            masks = torch.as_tensor(np.stack([s['mask'] for s in samples])) \
                if 'mask' in samples[0] else None
            emb_masks = self.eval_step(
                imgs.to(self.device),
                masks.to(self.device) if masks is not None else None,
                shard=False)[2]
            return emb_masks[:len(idxs)].permute(0, 2, 3, 1).float() \
                .cpu().numpy()

        paths = visualize_ranking_grid(
            distmat, query_loader.dataset.data(query_loader.mode),
            gallery_loader.dataset.data(gallery_loader.mode), out_dir,
            topk=topk, q_idx_list=q_idx_list, count=count, mAP=mAP,
            rank1=rank1, dataset_name=dataset_name, bp_distmat=bp_distmat,
            q_vis=q_vis, g_vis=g_vis, masks_fn=masks_for)
        print('Saved {} ranking grids to {}'.format(len(paths), out_dir))
        return paths

    def _evaluate(self, epoch, dataset_name='', query_loader=None,
                  gallery_loader=None, dist_metric='euclidean',
                  normalize_feature=False, visrank=False, visrank_topk=10,
                  visrank_q_idx_list=None, visrank_count=10, save_dir='',
                  use_metric_cuhk03=False, ranks=(1, 5, 10, 20), rerank=False,
                  save_features=False, **kwargs):
        """``evaluate`` on one target's loaders, printed and reported as
        the JAX engine does; with ``save_features`` (and a ``save_dir``)
        the features go to ``<save_dir>/features_<dataset_name>/``.
        With ``visrank`` the ranking grids go to
        ``<save_dir>/visrank_<dataset_name>/``. Returns ``(cmc, mAP, ssmd,
        pixel_accuracy)``."""
        entry = (getattr(self.datamanager, 'test_dataset', None)
                 or {}).get(dataset_name)
        eval_metric = getattr(entry['query'], 'eval_metric', 'default') \
            if entry else 'default'
        features_dir = osp.join(save_dir, 'features_{}'.format(
            dataset_name)) if save_features and save_dir else None
        embeddings_dir = osp.join(save_dir, 'embeddings_{}'.format(
            dataset_name)) if self.config is not None and \
            self.config.test.vis_embedding_projection else None
        res = self.evaluate(query_loader, gallery_loader,
                            normalize_feature=normalize_feature,
                            dist_metric=dist_metric, eval_metric=eval_metric,
                            use_metric_cuhk03=use_metric_cuhk03,
                            rerank=rerank, features_dir=features_dir,
                            visrank=visrank, visrank_topk=visrank_topk,
                            visrank_q_idx_list=visrank_q_idx_list,
                            visrank_count=visrank_count,
                            visrank_dir=osp.join(save_dir, 'visrank_{}'.format(
                                dataset_name)),
                            dataset_name=dataset_name,
                            embeddings_dir=embeddings_dir)
        cmc, mAP, ssmd = res['cmc'], res['mAP'], res['ssmd']
        if res['pixel_accuracy']:
            print('Pixel prediction accuracy: {:.2%}'.format(
                res['pixel_accuracy']))
        print('** Results **')
        print('mAP: {:.2%}'.format(mAP))
        print('CMC curve')
        for r in ranks:
            if r <= len(cmc):
                print('Rank-{:<3}: {:.2%}'.format(r, cmc[r - 1]))
        print('SSMD = {:.4f}'.format(ssmd))
        if self.writer is not None:
            self.writer.report_eval(dataset_name, cmc, mAP, ssmd)
        return cmc, mAP, ssmd, res['pixel_accuracy']

    def _chunked_device_eval(self, qf, gf, q_vis_arr, g_vis_arr, q_pids,
                             g_pids, q_camids, g_camids,
                             dist_metric='euclidean', max_rank=50,
                             part_bytes_budget=2 << 30):
        """Distractor-scale evaluation: query chunks through the device
        distance and the counting ranker.

        Each chunk of ``c = max(16, min(Nq, part_bytes_budget // (4 K
        Ng)))`` queries computes its own part distances (so the ``max + 1``
        sentinel is the chunk's maximum, as in JAX); the last chunk is
        padded to ``c`` with pid -1 queries, which never match and drop
        out as invalid. Chunk CMC/mAP partials combine weighted by their
        valid-query counts; a chunk where a query has more true matches
        than the counting ranker holds falls back to the full sort. The
        positive/negative pair-distance moments are f32 sums within a
        chunk and f64 across chunks (padded queries in neither set). With
        ``detailed_ranking`` the per-part CMC/mAP accumulate the same way.

        Args:
            qf, gf: ``[Nq, K, D]`` / ``[Ng, K, D]`` features on the device;
            q_vis_arr, g_vis_arr: ``[Nq, K]`` / ``[Ng, K]`` or None;
            q_pids, g_pids, q_camids, g_camids: numpy ids.
        Returns:
            ``(cmc, mAP, sub_distmat, sub_bp_distmat, n_q_host, sub_g_pids,
            sub_g_camids, part_rows, pair_stats)``: the ``sub_*`` arrays
            are the first chunk over up to 20,000 evenly spaced gallery
            columns; ``part_rows`` ``[(mAP_p, rank1_p)] * K`` or None;
            ``pair_stats`` ``(pos_mean, pos_std, neg_mean, neg_std)`` or
            None.
        """
        device = gf.device
        nq, ngal = len(q_pids), len(g_pids)
        k_streams = qf.shape[1]
        c = int(part_bytes_budget // max(1, 4 * k_streams * ngal))
        c = max(16, min(nq, c))
        max_rank = min(max_rank, ngal)
        g_pids_d = torch.as_tensor(g_pids, device=device)
        g_camids_d = torch.as_tensor(g_camids, device=device)

        cmc_sum = np.zeros(max_rank, np.float64)
        map_sum, n_valid_total = 0.0, 0
        part_r1_sum = np.zeros(k_streams, np.float64)
        part_map_sum = np.zeros(k_streams, np.float64)
        pair_acc = np.zeros(6, np.float64)   # pos: sum, sq, n; neg: ...

        def ranking(d, args):
            out = cmc_map_counting(d, *args, max_rank=max_rank)
            if int(out[3]):                  # exact full-sort fallback
                return cmc_map(d, *args, max_rank=max_rank)
            return out[:3]

        sub = sub_dist = sub_bp = None
        for start in range(0, nq, c):
            qf_c = qf[start:start + c]
            qv_c = q_vis_arr[start:start + c] \
                if q_vis_arr is not None else None
            qp_c = np.asarray(q_pids[start:start + c])
            qc_c = np.asarray(q_camids[start:start + c])
            if len(qp_c) < c:          # pad to the chunk size: pid -1
                pad = c - len(qp_c)
                qf_c = torch.cat([qf_c, qf_c.new_zeros(
                    (pad,) + tuple(qf_c.shape[1:]))])
                if qv_c is not None:   # all visible; never matches anyway
                    qv_c = torch.cat([qv_c, qv_c.new_ones(
                        (pad,) + tuple(qv_c.shape[1:]))])
                qp_c = np.concatenate([qp_c, -np.ones(pad, qp_c.dtype)])
                qc_c = np.concatenate([qc_c, np.zeros(pad, qc_c.dtype)])
            d_c, bp_c = self._distances(qf_c, gf, qv_c, g_vis_arr,
                                        dist_metric)
            args = (torch.as_tensor(qp_c, device=device), g_pids_d,
                    torch.as_tensor(qc_c, device=device), g_camids_d)
            pair_acc += _pair_moments(d_c, args[0], g_pids_d) \
                .cpu().numpy().astype(np.float64)
            cmc_c, map_c, nv_c = ranking(d_c, args)
            nv = int(nv_c)
            cmc_sum += cmc_c.cpu().numpy().astype(np.float64) * nv
            map_sum += float(map_c) * nv
            n_valid_total += nv
            if self.detailed_ranking:
                # query validity depends on pids and camids only: the same
                # nv weights every part
                for p in range(k_streams):
                    pc, pm, _ = ranking(bp_c[p], args)
                    part_r1_sum[p] += float(pc[0]) * nv
                    part_map_sum[p] += float(pm) * nv
            if sub is None:            # host statistics: the first chunk
                sub = np.unique(np.linspace(
                    0, ngal - 1, min(20_000, ngal)).astype(np.int64))
                n_real = min(c, nq - start)
                sub_d = torch.as_tensor(sub, device=device)
                sub_dist = d_c[:n_real, sub_d].cpu().numpy()
                sub_bp = bp_c[:, :n_real][..., sub_d].cpu().numpy()
            del d_c, bp_c
        if n_valid_total == 0:
            raise RuntimeError(
                'Error: all query identities do not appear in gallery')
        cmc = (cmc_sum / n_valid_total).astype(np.float32)
        mAP = map_sum / n_valid_total
        part_rows = [(part_map_sum[p] / n_valid_total,
                      part_r1_sum[p] / n_valid_total)
                     for p in range(k_streams)] \
            if self.detailed_ranking else None
        ps_, pq_, pn_, ns_, nq_, nn_ = pair_acc
        pair_stats = None
        if pn_ > 0 and nn_ > 0:
            pmean, nmean = ps_ / pn_, ns_ / nn_
            pair_stats = (pmean,
                          float(np.sqrt(max(0.0, pq_ / pn_ - pmean ** 2))),
                          nmean,
                          float(np.sqrt(max(0.0, nq_ / nn_ - nmean ** 2))))
        return (cmc, mAP, sub_dist, sub_bp, sub_dist.shape[0],
                np.asarray(g_pids)[sub], np.asarray(g_camids)[sub],
                part_rows, pair_stats)

    def _distances(self, qf, gf, q_vis, g_vis, dist_metric):
        """The query-gallery distances ``([Nq, Ng], [K, Nq, Ng])``: the
        gallery columns split over the ranks under a mesh
        (``parallel.sharded_bp_distance``, JAX :678-690), else in gallery
        blocks of ``batch_size_pairwise_dist_matrix``."""
        if self.mesh is not None and self.mesh.size > 1:
            d, bp, n_gal = sharded_bp_distance(
                self.mesh, qf, gf, q_vis, g_vis, self.dist_combine_strat,
                metric=dist_metric)
            return d[:, :n_gal], bp[..., :n_gal]
        return compute_distance_matrix_using_bp_features(
            qf, gf, q_vis, g_vis, self.dist_combine_strat,
            self.batch_size_pairwise_dist_matrix, metric=dist_metric)

    def display_individual_parts_ranking_performances(
            self, body_parts_distmat, g_camids, g_pids, q_camids, q_pids,
            eval_metric, precomputed_rows=None):
        """Per-stream ranking table (JAX :950): ``[(name, mAP %, rank-1
        %)]``, printed. At distractor scale the rows come from
        ``precomputed_rows`` (exact per-part partials of the chunked
        path), never from a subsample."""
        names = get_test_embeddings_names(self.parts_names,
                                          self.test_embeddings)

        def name(p):
            return names[p] if p < len(names) else 'p{}'.format(p)

        print('Parts embeddings individual rankings :')
        if precomputed_rows is not None:
            rows = [(name(p), float(m) * 100, float(r1) * 100)
                    for p, (m, r1) in enumerate(precomputed_rows)]
        else:
            rows = []
            for p in range(body_parts_distmat.shape[0]):
                try:
                    perf = evaluate_rank(body_parts_distmat[p], q_pids,
                                         g_pids, q_camids, g_camids,
                                         eval_metric=eval_metric)
                except (AssertionError, RuntimeError):
                    continue
                rows.append((name(p), float(perf['mAP']) * 100,
                             float(perf['cmc'][0]) * 100))
        print('{:<20} {:>8} {:>8}'.format('embedding', 'mAP', 'R-1'))
        for n, m, r1 in rows:
            print('{:<20} {:>8.2f} {:>8.2f}'.format(n, m, r1))
        return rows


def _pair_moments(d, qp, gp):
    """f32 ``[sum, sum of squares, count]`` of the positive then the
    negative pair distances of ``d [Q, G]``; queries with pid < 0 are in
    neither set."""
    valid = (qp >= 0)[:, None]
    same = (qp[:, None] == gp[None, :]) & valid
    diff = (qp[:, None] != gp[None, :]) & valid
    d32 = d.float()
    s, n = same.float(), diff.float()
    return torch.stack([(d32 * s).sum(), (d32 * d32 * s).sum(), s.sum(),
                        (d32 * n).sum(), (d32 * d32 * n).sum(), n.sum()])
