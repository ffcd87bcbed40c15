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
(``_train_multi_step_impl``, ``_eval_multi_step_impl``: :146-235) is
``Engine.forward_backward_multi`` over ``train_step`` and grouped
``feature_extraction``, through CUDA graphs on the card, as in the
part-based engine; the valid rows are taken on the device, so no group
is read back one behind as JAX's ``_drain_group`` reads it.

Under ``parallel.distribute_engine`` ``forward_backward`` takes the
global batch's draws, runs the model on this rank's slice and computes
the loss over the gathered outputs (its own slice live), so the cross
entropy and the batch-hard triplets see the global batch. Eval runs
whole on every rank (JAX shards only the part-based engine's eval).
"""
import numpy as np
import torch

from bpbreid_tpu_torch import resolve_device
from bpbreid_tpu_torch.data.augment import (eval_preprocess,
                                            sample_train_draws, slice_draws,
                                            train_augment)
from bpbreid_tpu_torch.engine.engine import Engine, normalize, valid_rows
from bpbreid_tpu_torch.losses import deep_supervision
from bpbreid_tpu_torch.losses.cross_entropy import CrossEntropyLoss
from bpbreid_tpu_torch.metrics.distance import compute_distance_matrix
from bpbreid_tpu_torch.models.common import set_dropout_generator
from bpbreid_tpu_torch.metrics.rank import evaluate_rank
from bpbreid_tpu_torch.parallel.mesh import gather_tree
from bpbreid_tpu_torch.utils.distribution import \
    plot_pairs_distance_distribution
from bpbreid_tpu_torch.utils.rerank import re_ranking
from bpbreid_tpu_torch.utils.tracing import span

__all__ = ['ImageSoftmaxEngine', 'supervised', 'first_head']


def supervised(criterion, outputs, pids):
    """``criterion`` of one head, or ``deep_supervision`` over a list or
    tuple of heads (torchreid's ``Engine.compute_loss``)."""
    if isinstance(outputs, (list, tuple)):
        return deep_supervision(criterion, outputs, pids)
    return criterion(outputs, pids)


def first_head(outputs):
    """The head torchreid's ``accuracy`` reads: the first of several."""
    return outputs[0] if isinstance(outputs, (list, tuple)) else outputs


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
        # the zoo's dropouts (PCB, NASNet) draw their masks from it
        set_dropout_generator(model, self.generator)

    # ------------------------------------------------------------------
    # train step
    # ------------------------------------------------------------------
    def compute_loss(self, outputs, pids):
        """Label-smoothed CE of the class scores, and the top-1
        accuracy (``_compute_loss`` :101). A model with several heads
        (a list or tuple of scores: PCB's strips, HACNN's two branches)
        gets the mean of their losses and the first head's accuracy, as
        torchreid's engine computes them; JAX's engine cannot train such
        a model (its cross entropy reads the list's ``shape``)."""
        loss = supervised(self.criterion, outputs, pids)
        acc = (first_head(outputs).argmax(dim=-1) == pids).float().mean()
        return loss, {'softmax': {'loss': loss.detach(), 'acc': acc}}

    def forward_backward(self, batch, draws=None):
        """One train step on ``batch`` (``image`` ``[B, H, W, 3]`` uint8,
        ``pid`` ``[B]``; numpy or tensors). ``draws`` are the augmentation
        draws (``data.augment.sample_train_draws``), taken from the
        engine's generator when None. Under a mesh ``batch`` and ``draws``
        are the global batch's. Returns ``(loss, summary)`` as tensors on
        the device (no host sync)."""
        self.require_optimizer()
        return self.train_step(*self.train_inputs(batch), draws=draws)

    def train_inputs(self, batch):
        """``(image, pid)`` of ``batch`` on the device."""
        return (torch.as_tensor(batch['image']).to(self.device),
                torch.as_tensor(batch['pid']).to(self.device))

    def train_step(self, imgs_u8, pids, draws=None):
        """The train step on device tensors (``forward_backward``'s, and
        what the train graph captures). Under a profiler its eager calls
        are the spans ``engine.forward`` (augmentation and the model),
        ``engine.loss``, ``engine.backward`` and ``engine.optimizer``, as
        the part-based engine's; a graph's replay runs none of them."""
        n, h, w = imgs_u8.shape[:3]
        if draws is None:
            draws = sample_train_draws(self.generator, n, h, w,
                                       self.transforms, **self.cj)
        if self.mesh is not None:
            lo, hi = self.shard(n)
            imgs_u8, draws = imgs_u8[lo:hi], slice_draws(draws, lo, hi)
        with span('engine.forward'):
            imgs, _ = train_augment(imgs_u8, None, draws,
                                    norm_mean=self.norm_mean,
                                    norm_std=self.norm_std)
            self.model.train()
            outputs = self.model(imgs)
        with span('engine.loss'):
            if self.mesh is not None:
                outputs = gather_tree(outputs, self.mesh)
            loss, summary = self.compute_loss(outputs, pids)
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
        :209). With ``test.batches_per_dispatch`` above 1 the batches go in
        groups (``_eval_batch_groups``), each batch through the eval
        graph with ``eval_graphs``, as the part-based engine's; the valid
        rows are taken by index tensors made from the host's ``valid``."""
        f_, pids_, camids_ = [], [], []
        for batch, feats in self._eval_batches(loader, self.eval_step):
            valid = batch['valid']
            f_.append(valid_rows(feats, valid))
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
