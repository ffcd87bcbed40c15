"""Random occlusion: paste segmented objects onto crops (port of
bpbreid_tpu/data/data_augmentation/random_occlusion.py).

``n`` occluder patches are pasted per image, each scaled to cover a
share of the crop drawn from ``[min_overlap, max_overlap]``; labels and
masks are left as they are. The occluders come from a Pascal-VOC tree
(``JPEGImages`` + ``SegmentationObject``) when ``path`` names one, else
from a synthetic bank of 32 noisy ellipses drawn from the seed, which
needs no files. It runs on the host, on each decoded sample (the
loader's ``host_transform``): the patches' shapes vary from draw to draw.

The JAX package resizes a patch with ``cv2.resize`` and reads the VOC
tree with ``cv2.imread``; the port imports no OpenCV. Its
``resize_linear`` computes OpenCV's uint8 path (bit-equal at 4 channels
too, ``tests/test_torch_occlusion_options.py``), the segmentation PNGs
go through the port's decoder and the JPEGs through PIL
(``data/datasets/dataset.py read_image``). The draws come from one
``np.random.Generator`` seeded as JAX's, in the same order.
"""
import glob
import os.path as osp

import numpy as np

from bpbreid_tpu_torch.data.datasets.dataset import read_image, resize_linear

__all__ = ['RandomOcclusion', 'OccluderBank']


class OccluderBank:
    """A list of RGBA uint8 occluder patches ``[h, w, 4]``."""

    def __init__(self, path='', max_occluders=200, seed=0):
        self.patches = []
        if path and osp.isdir(path):
            self._load_voc(path, max_occluders)
        if not self.patches:
            self._make_synthetic(seed)

    def _load_voc(self, path, max_occluders):
        """Each object segmentation's bounding box, cut from its image,
        with the segmented pixels as alpha; segmentations of fewer than
        100 pixels are skipped."""
        seg_dir = osp.join(path, 'SegmentationObject')
        img_dir = osp.join(path, 'JPEGImages')
        seg_paths = sorted(glob.glob(osp.join(seg_dir, '*.png')))
        for seg_path in seg_paths[:max_occluders]:
            name = osp.splitext(osp.basename(seg_path))[0]
            img_path = osp.join(img_dir, name + '.jpg')
            if not osp.exists(img_path):
                continue
            try:
                seg, img = read_image(seg_path), read_image(img_path)
            except IOError:
                continue
            total = seg.astype(np.int64).sum(axis=-1)
            mask = (total > 0) & (total < 255 * 3)
            ys, xs = np.where(mask)
            if len(ys) < 100:
                continue
            y0, y1, x0, x1 = ys.min(), ys.max(), xs.min(), xs.max()
            patch = np.dstack([img[y0:y1 + 1, x0:x1 + 1],
                               mask[y0:y1 + 1, x0:x1 + 1][..., None]
                               .astype(np.uint8) * 255])
            self.patches.append(patch)

    def _make_synthetic(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(32):
            h, w = rng.integers(24, 64, 2)
            color = rng.integers(0, 255, 3)
            patch = np.zeros((h, w, 4), np.uint8)
            yy, xx = np.mgrid[0:h, 0:w]
            cy, cx = h / 2, w / 2
            ellipse = (((yy - cy) / (h / 2)) ** 2
                       + ((xx - cx) / (w / 2)) ** 2) <= 1.0
            noise = rng.integers(-30, 30, (h, w, 3))
            patch[..., :3] = np.clip(color + noise, 0, 255)
            patch[..., 3] = ellipse.astype(np.uint8) * 255
            self.patches.append(patch)

    def sample(self, rng):
        return self.patches[rng.integers(0, len(self.patches))]


class RandomOcclusion:
    """Sample transform: an RGB uint8 ``[H, W, 3]`` image -> the image
    with, at probability ``p``, ``n`` occluders pasted (alpha above 127
    replaces the pixel)."""

    def __init__(self, path='', p=0.5, n=1, min_overlap=0.5,
                 max_overlap=0.8, seed=0):
        self.bank = OccluderBank(path, seed=seed)
        self.p = p
        self.n = n
        self.min_overlap = min_overlap
        self.max_overlap = max_overlap
        self.rng = np.random.default_rng(seed)

    def __call__(self, image):
        if self.rng.random() > self.p:
            return image
        img = image.copy()
        h, w = img.shape[:2]
        for _ in range(self.n):
            patch = self.bank.sample(self.rng)
            overlap = self.rng.uniform(self.min_overlap, self.max_overlap)
            # scale the occluder to cover `overlap` of the crop's area
            ph, pw = patch.shape[:2]
            scale = np.sqrt(overlap * h * w / (ph * pw))
            nh = max(2, min(h, int(ph * scale)))
            nw = max(2, min(w, int(pw * scale)))
            patch_r = resize_linear(patch, nh, nw)
            y0 = int(self.rng.integers(0, max(1, h - nh + 1)))
            x0 = int(self.rng.integers(0, max(1, w - nw + 1)))
            alpha = (patch_r[..., 3:4] > 127).astype(img.dtype)
            region = img[y0:y0 + nh, x0:x0 + nw]
            img[y0:y0 + nh, x0:x0 + nw] = (
                region * (1 - alpha) + patch_r[..., :3] * alpha)
        return img
