"""Inference API: image paths or arrays (and optional external part
masks) -> the model's outputs (port of
bpbreid_tpu/tools/feature_extractor.py).

Builds the model and the test preprocessing from a config, or takes an
engine's; callable on a list of image paths, a list of HWC uint8 arrays,
or one batched array. Each image is resized to ``data.height x
data.width`` with ``resize_linear`` (what the JAX extractor's
``cv2.resize`` computes, bit for bit) and files are decoded with
``read_image``. With ``test.int8`` the model runs the calibrated int8
graph (``ops/quant.py``): the activation ranges are recorded on the first
batch, at ``test.int8_calib_percentile`` (JAX ``_ensure_int8`` :85), or
taken from the engine when it has calibrated the shared model.

Without part masks the model runs on the images alone, as JAX's
``forward_nomask`` (:70) does: a BPBReID gives its output tuple, a
global-embedding model of the zoo (``osnet_x1_0`` with ``loss.name
softmax``, say) its ``[N, D]`` embedding.
"""
import numpy as np
import torch

from bpbreid_tpu_torch import resolve_device
from bpbreid_tpu_torch.data.augment import eval_preprocess, mask_chain_kwargs
from bpbreid_tpu_torch.data.datasets.dataset import read_image, resize_linear
from bpbreid_tpu_torch.models import build_model
from bpbreid_tpu_torch.ops.masks import GroupingSpec, masks_preprocess_all
from bpbreid_tpu_torch.ops.quant import (QuantOpts, clear_calibration,
                                         int8_calibration)
from bpbreid_tpu_torch.utils.torch_weights import (load_torch_state_dict,
                                                   load_torchreid_state_dict)

__all__ = ['FeatureExtractor']


class FeatureExtractor:
    """Args:
        cfg: the config (``data.height``, ``data.width``, the norm, the
            model and its mask grouping).
        model_path: a torchreid state dict to load into the model built
            here (``utils.torch_weights``).
        device: torch device of a model built here; ``None`` means
            ``'cuda'`` (and raises without CUDA). With ``engine``, the
            engine's device.
        num_classes: identity classes of a model built here.
        model: a built port model to use instead of building one.
        engine: an engine (``ImagePartBasedEngine``, or the softmax or
            triplet engine of a zoo model) whose model, device and mask
            parameters to use.
    """

    def __init__(self, cfg, model_path='', device=None, num_classes=1,
                 model=None, engine=None, verbose=True):
        self.height, self.width = cfg.data.height, cfg.data.width
        self.norm_mean = tuple(cfg.data.norm_mean)
        self.norm_std = tuple(cfg.data.norm_std)
        if engine is not None:
            self.model, self.device = engine.model, engine.device
            self.mask_kwargs = engine.mask_kwargs
        else:
            self.device = resolve_device(device)
            self.model = model if model is not None else build_model(
                cfg.model.name, num_classes, loss=cfg.loss.name,
                pretrained=cfg.model.pretrained, config=cfg,
                device=self.device)
            spec = masks_preprocess_all.get(cfg.model.bpbreid.masks.preprocess)
            self.mask_kwargs = mask_chain_kwargs(cfg) \
                if isinstance(spec, GroupingSpec) else None
            if model_path:
                sd, _ = load_torch_state_dict(model_path)
                matched, _ = load_torchreid_state_dict(self.model, sd)
                print('Loaded {} tensors from {}'.format(len(matched),
                                                         model_path))
        self.quant_opts = QuantOpts.from_config(cfg.test) \
            if cfg.test.int8 else None
        self.calib_percentile = float(cfg.test.int8_calib_percentile)
        self.int8_ready = engine is not None and engine.int8_calibrated
        if verbose:
            print('FeatureExtractor ready: {} @ {}x{} on {}{}'.format(
                cfg.model.name, self.height, self.width, self.device,
                ' [int8]' if self.quant_opts is not None else ''))

    def _prepare(self, inputs):
        arrays = []
        for item in inputs:
            img = read_image(item) if isinstance(item, str) \
                else np.asarray(item)
            if img.shape[:2] != (self.height, self.width):
                img = resize_linear(img, self.height, self.width)
            arrays.append(img.astype(np.uint8))
        return np.stack(arrays)

    @torch.inference_mode()
    def __call__(self, inputs, external_parts_masks=None):
        """The model's raw output for the batch, on the device: a BPBReID's
        tuple (embeddings, visibility scores, id scores, pixel scores,
        spatial features, masks), a zoo model's ``[N, D]`` embedding.

        Args:
            inputs: a list of image paths or ``[H, W, 3]`` uint8 arrays,
                or one ``[N, H, W, 3]`` / ``[H, W, 3]`` uint8 array at
                ``data.height x data.width``.
            external_parts_masks: ``[N, h, w, C]`` float confidence
                fields, or None.
        """
        if isinstance(inputs, (list, tuple)):
            imgs = self._prepare(inputs)
        else:
            imgs = np.asarray(inputs)
            if imgs.ndim == 3:
                imgs = imgs[None]
        imgs = torch.as_tensor(imgs, device=self.device)
        masks = None if external_parts_masks is None else torch.as_tensor(
            external_parts_masks, device=self.device)
        imgs, masks = eval_preprocess(imgs, masks, norm_mean=self.norm_mean,
                                      norm_std=self.norm_std,
                                      mask_kwargs=self.mask_kwargs)
        self.model.eval()
        args = (imgs,) if masks is None else (imgs, masks)
        if self.quant_opts is None:
            return self.model(*args)
        if not self.int8_ready:
            clear_calibration(self.model)
            with int8_calibration(percentile=self.calib_percentile):
                self.model(*args)
            self.int8_ready = True
        with self.quant_opts.inference_context():
            return self.model(*args)
