"""Offline human-parsing label generation (port of
bpbreid_tpu/scripts/get_labels.py; the reference's
torchreid/scripts/get_labels.py:173-521).

Run a pose estimator over every dataset image to produce 36-channel
PifPaf confidence fields (17 keypoint pif + 19 joint paf channels),
optionally filtered by a person-segmentation model, saved as
``masks/<masks_dir>/.../<image>.confidence_fields.npy`` next to the
dataset.

The external models (openpifpaf, detectron2 Mask-RCNN) sit behind the
``PoseEstimatorBackend`` / ``SegmentationBackend`` interfaces, each
import-gated with a clear ``ImportError``. A deterministic ``synthetic``
backend serves tests and dry runs without them. Images are decoded by
the port's ``read_image`` and the person mask is resized by its
``resize_linear`` (``cv2.resize``'s bilinear), so no OpenCV is needed.
"""
import argparse
import glob
import os
import os.path as osp

import numpy as np

from bpbreid_tpu_torch.data.datasets.dataset import read_image, resize_linear

__all__ = ['PoseEstimatorBackend', 'SegmentationBackend',
           'SyntheticPoseBackend', 'OpenPifPafBackend', 'MaskRCNNBackend',
           'extract_confidence_fields', 'select_person_mask',
           'order_boxes_by_center_distance', 'generate_labels']


class PoseEstimatorBackend:
    """Produces [H', W', 36] confidence fields for an RGB uint8 image."""

    def __call__(self, image):
        raise NotImplementedError


class SegmentationBackend:
    """Produces a [H, W] person-probability mask for an RGB uint8 image."""

    def __call__(self, image):
        raise NotImplementedError


class SyntheticPoseBackend(PoseEstimatorBackend):
    """Deterministic pseudo-fields: per-channel gaussians arranged along
    the vertical body axis — enough to exercise the full mask pipeline."""

    def __init__(self, scale=8, seed=0):
        self.scale = scale
        self.seed = seed

    def __call__(self, image):
        h, w = image.shape[:2]
        fh, fw = max(1, h // self.scale), max(1, w // self.scale)
        yy = np.linspace(0, 1, fh)[:, None]
        xx = np.linspace(0, 1, fw)[None, :]
        fields = np.zeros((fh, fw, 36), np.float32)
        rng = np.random.default_rng(self.seed + int(image.sum()) % 1000)
        for c in range(36):
            cy = (c + 0.5) / 36.0
            cx = 0.5 + 0.15 * np.sin(c)
            g = np.exp(-(((yy - cy) / 0.15) ** 2 + ((xx - cx) / 0.3) ** 2))
            fields[..., c] = g * (0.5 + 0.5 * rng.random())
        return fields


def extract_confidence_fields(pif, paf):
    """Raw PifPaf head fields -> the 36-channel confidence map.

    This pins the npy layout contract of the reference tool
    (reference: get_labels.py:254-279): each of the 17 keypoint (pif)
    fields and 19 joint-association (paf) fields carries its confidence
    values in plane index 1; the confidence planes are concatenated
    pif-first along the channel axis.

    Args:
        pif: [17, P>=2, h, w] keypoint fields.
        paf: [19, P>=2, h, w] association fields.
    Returns:
        [h, w, 36] float32 confidence map (channel-last; callers store
        channel-first on disk, matching the reference).
    """
    pif = np.asarray(pif, np.float32)
    paf = np.asarray(paf, np.float32)
    if pif.shape[0] != 17 or paf.shape[0] != 19:
        raise ValueError('expected 17 pif / 19 paf fields, got '
                         '{} / {}'.format(pif.shape[0], paf.shape[0]))
    conf = np.concatenate([pif[:, 1], paf[:, 1]], axis=0)   # [36, h, w]
    return np.transpose(conf, (1, 2, 0))


class OpenPifPafBackend(PoseEstimatorBackend):
    """openpifpaf confidence fields (reference: get_labels.py:197-279).

    ``predictor`` can be injected (anything exposing the
    ``openpifpaf.Predictor`` surface used here) for testing without the
    external dependency.
    """

    def __init__(self, checkpoint='shufflenetv2k30', predictor=None):
        if predictor is None:
            try:
                import openpifpaf
            except ImportError as e:
                raise ImportError(
                    'openpifpaf is not installed in this environment; use '
                    "the 'synthetic' backend or install openpifpaf for "
                    'real labels') from e
            predictor = openpifpaf.Predictor(checkpoint=checkpoint)
        self.predictor = predictor

    def __call__(self, image):
        # run the network's preprocessing + forward, keep the raw head
        # fields (not the decoded skeletons) and extract the confidence
        # planes — the behavioral contract of reference get_labels.py:
        # 244-279 (fields_batch -> pif/paf -> [:, 1] -> concat)
        batch = self.predictor.preprocess_factory()(image)
        fields = self.predictor.processor.fields_batch(
            self.predictor.model, batch)[0]
        pif, paf = fields[0], fields[1]
        return extract_confidence_fields(pif, paf)


def order_boxes_by_center_distance(image_size, boxes):
    """Indices of ``boxes`` sorted by their center's euclidean distance
    to the image center (reference: get_labels.py order_bbox, :420-436 —
    integer-floor centers, stable sort on distance)."""
    image_height, image_width = image_size
    center_x, center_y = image_width // 2, image_height // 2
    distances = []
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        bcx, bcy = (x1 + x2) // 2, (y1 + y2) // 2
        distances.append((i, np.sqrt((bcx - center_x) ** 2
                                     + (bcy - center_y) ** 2)))
    return [i for i, _ in sorted(distances, key=lambda t: t[1])]


def select_person_mask(instances):
    """Closest-to-center person mask from detectron2-style instances.

    Pins the reference's filtering contract (get_labels.py:438-452):
    keep ``pred_classes == 0`` (COCO person), order the survivors by
    bbox-center distance to the image center, return the nearest one.
    Raises when the detector returned no masks at all (the reference's
    hard error) and falls back to an all-ones mask when masks exist but
    none is a person (keep the fields rather than zeroing them).

    Args:
        instances: object with ``image_size`` (h, w) and
            ``pred_boxes``/``pred_classes``/``pred_masks`` fields
            (tensors or arrays; one [H, W] bool/float mask per
            detection).
    Returns:
        [H, W] float32 person mask.
    """
    boxes = np.asarray([np.asarray(b) for b in instances.pred_boxes])
    classes = np.asarray(instances.pred_classes)
    masks = [np.asarray(m) for m in instances.pred_masks]
    if len(masks) == 0:
        raise RuntimeError(
            'segmentation model did not return any masks')
    keep = [i for i, c in enumerate(classes) if c == 0]
    if not keep:
        h, w = instances.image_size
        return np.ones((h, w), np.float32)
    order = order_boxes_by_center_distance(
        instances.image_size, [boxes[i] for i in keep])
    return masks[keep[order[0]]].astype(np.float32)


class MaskRCNNBackend(SegmentationBackend):
    """detectron2 person masks (reference: get_labels.py:404-484).

    ``predictor`` can be injected (anything callable as
    ``predictor(image) -> {'instances': ...}`` like
    ``detectron2.engine.DefaultPredictor``) for testing without the
    external dependency.
    """

    def __init__(self, predictor=None,
                 config='COCO-InstanceSegmentation/'
                        'mask_rcnn_R_50_FPN_3x.yaml'):
        if predictor is None:
            try:
                from detectron2 import model_zoo
                from detectron2.config import get_cfg
                from detectron2.engine import DefaultPredictor
            except ImportError as e:
                raise ImportError(
                    'detectron2 is not installed in this environment; '
                    'omit --filter or install detectron2') from e
            cfg = get_cfg()
            cfg.merge_from_file(model_zoo.get_config_file(config))
            cfg.MODEL.WEIGHTS = model_zoo.get_checkpoint_url(config)
            predictor = DefaultPredictor(cfg)
        self.predictor = predictor

    def __call__(self, image):
        # detectron2 predictors consume BGR (reference feeds cv2 frames)
        result = self.predictor(image[..., ::-1])
        return select_person_mask(result['instances'])


def generate_labels(dataset_root, masks_dir='pifpaf', backend=None,
                    seg_backend=None, image_glob='**/*.jpg',
                    masks_base_dir='masks', limit=None):
    """Run the backend over every image and save confidence fields.

    Output layout matches the reference (dataset/masks/<masks_dir>/
    <subdir>/<image>.npy with channel-first storage, get_labels.py:108).
    """
    backend = backend or SyntheticPoseBackend()
    images = sorted(glob.glob(osp.join(dataset_root, image_glob),
                              recursive=True))
    images = [p for p in images
              if masks_base_dir not in osp.relpath(p, dataset_root)]
    if limit:
        images = images[:limit]
    out_paths = []
    for img_path in images:
        img = read_image(img_path)
        fields = backend(img)                     # [h, w, 36]
        if seg_backend is not None:
            person = seg_backend(img)
            ph, pw = fields.shape[:2]
            person = resize_linear(person.astype(np.float32)[..., None],
                                   ph, pw)[..., 0]
            fields = fields * person[..., None]
        rel = osp.relpath(img_path, dataset_root)
        out = osp.join(dataset_root, masks_base_dir, masks_dir,
                       osp.dirname(rel),
                       osp.basename(img_path) + '.confidence_fields.npy')
        os.makedirs(osp.dirname(out), exist_ok=True)
        # store channel-first like the reference tool
        np.save(out, np.transpose(fields, (2, 0, 1)))
        out_paths.append(out)
    print('Generated {} mask files under {}'.format(
        len(out_paths), osp.join(dataset_root, masks_base_dir, masks_dir)))
    return out_paths


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--source', required=True,
                        help='dataset root directory')
    parser.add_argument('--backend', default='synthetic',
                        choices=['synthetic', 'pifpaf'])
    parser.add_argument('--filter', action='store_true',
                        help='apply Mask-RCNN person filtering')
    parser.add_argument('--masks-dir', default=None)
    parser.add_argument('--limit', type=int, default=None)
    args = parser.parse_args(argv)

    backend = SyntheticPoseBackend() if args.backend == 'synthetic' \
        else OpenPifPafBackend()
    seg = MaskRCNNBackend() if args.filter else None
    masks_dir = args.masks_dir or (
        'pifpaf_maskrcnn_filtering' if args.filter else 'pifpaf')
    generate_labels(args.source, masks_dir=masks_dir, backend=backend,
                    seg_backend=seg, limit=args.limit)


if __name__ == '__main__':
    main()
