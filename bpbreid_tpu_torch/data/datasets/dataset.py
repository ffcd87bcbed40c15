"""Dataset base classes (port of bpbreid_tpu/data/datasets/dataset.py).

train/query/gallery are lists of sample dicts ``{img_path, pid, camid,
masks_path}`` with ``combine_all``, dataset addition (pid re-labeling)
and per-dataset mask metadata.
``ImageDataset.get`` decodes one sample to fixed-size numpy arrays on the
host (decode + resize only); augmentation runs on the device
(``data/augment.py``).

The JAX package resizes with OpenCV's ``cv2.resize(INTER_LINEAR)``. The
port imports neither OpenCV nor PIL at import time: ``resize_linear``
computes what ``cv2.resize`` computes, in numpy. For uint8 images that is
OpenCV's fixed-point path (11-bit interpolation weights, an integer
horizontal pass, then the vertical pass of its x86 vector code:
``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2 >> 2``); for
float fields its float path. Source columns are clamped with their
weight moved onto the edge pixel, source rows only clamped, as OpenCV
does. ``tests/test_torch_data_pipeline.py`` holds both against
``cv2.resize``.
"""
import copy
import io
import os
import os.path as osp
import struct
import zlib

import numpy as np

__all__ = ['Dataset', 'ImageDataset', 'read_image', 'read_masks',
           'resize_linear', 'write_png', 'read_png_text']

_COEF_SCALE = np.float32(2048)        # OpenCV INTER_RESIZE_COEF_SCALE


def _taps(dst, src, clamp):
    """Source index and float32 fraction of each output coordinate,
    ``(d + 0.5) * src / dst - 0.5``; with ``clamp`` (columns) an index
    outside ``[0, src - 1)`` is clamped and its fraction zeroed."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= src - 1)
        f[edge] = 0
        s = np.clip(s, 0, src - 1)
    return s, f


def resize_linear(img, height, width):
    """``cv2.resize(img, (width, height), interpolation=INTER_LINEAR)``
    for ``[H, W, C]`` uint8 or float arrays (float comes back float32)."""
    h_in, w_in = img.shape[:2]
    sx, fx = _taps(width, w_in, clamp=True)
    sy, fy = _taps(height, h_in, clamp=False)
    x1 = np.minimum(sx + 1, w_in - 1)
    y0, y1 = np.clip(sy, 0, h_in - 1), np.clip(sy + 1, 0, h_in - 1)
    one = np.float32(1)
    if img.dtype == np.uint8:
        a0 = np.rint((one - fx) * _COEF_SCALE).astype(np.int32)[:, None]
        a1 = np.rint(fx * _COEF_SCALE).astype(np.int32)[:, None]
        b0 = np.rint((one - fy) * _COEF_SCALE).astype(np.int32)[:, None, None]
        b1 = np.rint(fy * _COEF_SCALE).astype(np.int32)[:, None, None]
        src = img.astype(np.int32)
        rows = src[:, sx] * a0 + src[:, x1] * a1
        out = ((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16)
        return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    src = img.astype(np.float32)
    rows = src[:, sx] * (one - fx)[:, None] + src[:, x1] * fx[:, None]
    return rows[y0] * (one - fy)[:, None, None] + rows[y1] * fy[:, None, None]


class Dataset:
    _junk_pids = []
    masks_base_dir = None
    eval_metric = 'default'
    dataset_dir = ''
    masks_dirs = {}

    @classmethod
    def get_masks_config(cls, masks_dir):
        return cls.masks_dirs.get(masks_dir, None)

    def gallery_filter(self, q_pid, q_camid, q_ann, g_pids, g_camids, g_anns):
        """The gallery samples that share the query's identity and camera
        (JAX :33, reference dataset.py:35-40): True where removed."""
        return (g_camids == q_camid) & (g_pids == q_pid)

    def infer_masks_path(self, img_path):
        return os.path.join(
            self.dataset_dir, self.masks_base_dir, self.masks_dir,
            os.path.basename(os.path.dirname(img_path)),
            os.path.splitext(os.path.basename(img_path))[0] + self.masks_suffix)

    def __init__(self, train, query, gallery, config=None, mode='train',
                 combineall=False, verbose=True, use_masks=False,
                 masks_dir=None, masks_base_dir=None, **kwargs):
        self.train = train
        self.query = query
        self.gallery = gallery
        self.cfg = config
        self.mode = mode
        self.combineall = combineall
        self.verbose = verbose
        self.use_masks = use_masks
        self.masks_dir = masks_dir
        if masks_base_dir is not None:
            self.masks_base_dir = masks_base_dir

        self.num_train_pids = self.get_num_pids(self.train)
        self.num_train_cams = self.get_num_cams(self.train)
        if self.combineall:
            self.combine_all()
        if self.verbose:
            self.show_summary()

    def data(self, mode):
        if mode == 'train':
            return self.train
        if mode == 'query':
            return self.query
        if mode == 'gallery':
            return self.gallery
        raise ValueError("Invalid mode. Got {}, but expected 'train', "
                         "'query' or 'gallery'".format(mode))

    def len(self, mode):
        return len(self.data(mode))

    def __len__(self):
        return self.len(self.mode)

    def __add__(self, other):
        train = copy.deepcopy(self.train)
        for sample in other.train:
            sample = dict(sample)
            sample['pid'] += self.num_train_pids
            train.append(sample)
        if self.use_masks != other.use_masks:
            raise ValueError('cannot add datasets with and without masks')
        return ImageDataset(train, self.query, self.gallery, mode=self.mode,
                            combineall=False, verbose=False,
                            use_masks=self.use_masks,
                            masks_base_dir=self.masks_base_dir)

    def __radd__(self, other):
        return self if other == 0 else self.__add__(other)

    @staticmethod
    def parse_data(data):
        pids = {s['pid'] for s in data}
        cams = {s['camid'] for s in data}
        return len(pids), len(cams)

    def get_num_pids(self, data):
        return self.parse_data(data)[0]

    def get_num_cams(self, data):
        return self.parse_data(data)[1]

    def show_summary(self):
        pass

    def combine_all(self):
        """Merge the query and gallery identities into train."""
        combined = copy.deepcopy(self.train)
        g_pids = {s['pid'] for s in self.gallery
                  if s['pid'] not in self._junk_pids}
        pid2label = {pid: i for i, pid in enumerate(sorted(g_pids))}

        def _combine(data):
            for s in data:
                if s['pid'] in self._junk_pids:
                    continue
                s = dict(s)
                s['pid'] = pid2label[s['pid']] + self.num_train_pids
                combined.append(s)

        _combine(self.query)
        _combine(self.gallery)
        self.train = combined
        self.num_train_pids = self.get_num_pids(self.train)

    def check_before_run(self, required_files):
        if isinstance(required_files, str):
            required_files = [required_files]
        for fpath in required_files:
            if not osp.exists(fpath):
                raise RuntimeError('"{}" is not found'.format(fpath))

    def __repr__(self):
        tp, tc = self.parse_data(self.train)
        qp, qc = self.parse_data(self.query)
        gp, gc = self.parse_data(self.gallery)
        return ('  ----------------------------------------\n'
                '  subset   | # ids | # items | # cameras\n'
                '  ----------------------------------------\n'
                '  train    | {:5d} | {:7d} | {:9d}\n'
                '  query    | {:5d} | {:7d} | {:9d}\n'
                '  gallery  | {:5d} | {:7d} | {:9d}\n'
                '  ----------------------------------------\n').format(
                    tp, len(self.train), tc, qp, len(self.query), qc,
                    gp, len(self.gallery), gc)


_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}     # 8-bit gray, RGB, RGBA


def _png_chunks(data):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length             # length, type, body, CRC


def _unfilter_average(line, prior, bpp):
    cur, up = bytearray(line.tobytes()), prior.tobytes()
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 255
    return np.frombuffer(cur, np.uint8)


def _unfilter_paeth(line, prior, bpp):
    cur, up = bytearray(line.tobytes()), prior.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b, c = up[i], (up[i - bpp] if i >= bpp else 0)
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255
    return np.frombuffer(cur, np.uint8)


def _decode_png(data):
    """An 8-bit gray, RGB or RGBA non-interlaced PNG -> RGB uint8 ``[H,
    W, 3]`` (gray replicated, alpha dropped, as ``cv2.imread`` gives
    after its BGR -> RGB swap); None for any other PNG variant."""
    chunks = list(_png_chunks(data))
    if not chunks or chunks[0][0] != b'IHDR':
        raise OSError('PNG without an IHDR chunk')
    width, height, depth, color, _, _, interlace = struct.unpack(
        '>IIBBBBB', chunks[0][1][:13])
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        return None
    bpp = _PNG_CHANNELS[color]
    stride = width * bpp
    try:
        raw = zlib.decompress(b''.join(b for k, b in chunks if k == b'IDAT'))
    except zlib.error as e:
        raise OSError('corrupt PNG data: {}'.format(e)) from e
    if len(raw) < height * (stride + 1):
        raise OSError('truncated PNG data')
    rows = np.frombuffer(raw, np.uint8, count=height * (stride + 1)) \
        .reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:                # Sub: a running sum per channel
            out[y] = np.cumsum(line.reshape(width, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:                # Up
            out[y] = line + prior
        elif kind == 3:
            out[y] = _unfilter_average(line, prior, bpp)
        elif kind == 4:
            out[y] = _unfilter_paeth(line, prior, bpp)
        else:
            raise OSError('PNG row filter {} does not exist'.format(kind))
        prior = out[y]
    img = out.reshape(height, width, bpp)
    return np.repeat(img, 3, axis=2) if bpp == 1 \
        else np.ascontiguousarray(img[..., :3])


def _format_name(data, path):
    if data.startswith(_PNG_SIGNATURE):
        _, _, depth, color, _, _, interlace = struct.unpack(
            '>IIBBBBB', data[16:29])
        return 'PNG (bit depth {}, color type {}{})'.format(
            depth, color, ', interlaced' if interlace else '')
    if data.startswith(b'\xff\xd8'):
        return 'JPEG'
    return 'the {} file'.format(osp.splitext(path)[1] or 'extensionless')


def _decode_image(path, data):
    if data.startswith(_PNG_SIGNATURE):
        img = _decode_png(data)
        if img is not None:
            return img
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            'decoding {} ({}) needs PIL (Pillow), which is not installed; '
            'only 8-bit gray, RGB and RGBA non-interlaced PNGs decode '
            'without it'.format(_format_name(data, path), path)) from e
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert('RGB'))


def read_image(path):
    """Image file -> RGB uint8 ``[H, W, 3]``, with two retries on a
    failed read. 8-bit gray, RGB and RGBA non-interlaced PNGs are decoded
    here with the standard library (``zlib``): PNG is lossless, so these
    are the pixels ``cv2.imread`` gives. Every other file goes through
    PIL, imported here, and raises naming its format where PIL is
    absent."""
    err = None
    for _ in range(3):
        try:
            with open(path, 'rb') as f:
                data = f.read()
            return _decode_image(path, data)
        except OSError as e:
            err = e
    raise IOError('Failed to read image: {} ({})'.format(path, err))


def _png_chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xffffffff))


def write_png(path, img, text=None):
    """Write an RGB uint8 ``[H, W, 3]`` image as an 8-bit RGB PNG (no
    row filter, ``zlib`` level 6), with one ``tEXt`` chunk for each
    ``(keyword, text)`` of ``text`` (Latin-1), before the image data.
    ``read_image`` reads the pixels back, ``read_png_text`` the text."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError('write_png takes [H, W, 3] uint8, got {}'.format(
            img.shape))
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()
    chunks = [_png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0,
                                              0))]
    for key, value in (text or {}).items():
        chunks.append(_png_chunk(b'tEXt', key.encode('latin-1') + b'\0'
                                 + str(value).encode('latin-1')))
    chunks += [_png_chunk(b'IDAT', zlib.compress(raw, 6)),
               _png_chunk(b'IEND', b'')]
    with open(path, 'wb') as f:
        f.write(_PNG_SIGNATURE + b''.join(chunks))


def read_png_text(path):
    """The ``tEXt`` chunks of a PNG file as ``{keyword: text}``."""
    with open(path, 'rb') as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise OSError('{} is not a PNG file'.format(path))
    out = {}
    for kind, body in _png_chunks(data):
        if kind == b'tEXt':
            key, _, value = body.partition(b'\0')
            out[key.decode('latin-1')] = value.decode('latin-1')
    return out


def read_masks(path):
    """A ``.npy`` confidence-field tensor, stored channel-first, as
    float32 ``[H, W, C]``."""
    masks = np.load(path)
    if masks.ndim != 3:
        raise ValueError('masks at {} must be 3-D, got {}'.format(
            path, masks.shape))
    return np.transpose(masks, (1, 2, 0)).astype(np.float32)


class ImageDataset(Dataset):
    """Image dataset: ``get(mode, index, height, width, mask_grid)``
    returns the sample dict with the decoded image resized to
    ``height x width`` and, with masks, the confidence fields resized to
    ``mask_grid`` (``(mh, mw)``; None: the image grid). The fields are
    stored near their estimator's low resolution, so the loader ships
    them at a fraction of the image grid and the device pipeline
    upsamples them."""

    def get(self, mode, index, height=None, width=None, mask_grid=None):
        sample = dict(self.data(mode)[index])
        if 'img' in sample:
            img = sample['img']
        else:
            img = read_image(sample['img_path'])
        if height is not None and (img.shape[0] != height
                                   or img.shape[1] != width):
            img = resize_linear(img, height, width)
        sample['image'] = img
        if self.use_masks:
            if 'masks' in sample:
                masks = sample['masks']
            elif sample.get('masks_path'):
                masks = read_masks(sample['masks_path'])
            else:
                raise ValueError('use_masks=True but sample has no masks')
            mh, mw = (mask_grid if mask_grid is not None
                      else (height, width))
            if mh is not None and (masks.shape[0] != mh
                                   or masks.shape[1] != mw):
                masks = resize_linear(masks, mh, mw)
            sample['mask'] = masks.astype(np.float32)
        return sample

    def show_summary(self):
        if self.verbose:
            print('=> Loaded {}'.format(self.__class__.__name__))
            print(repr(self))
