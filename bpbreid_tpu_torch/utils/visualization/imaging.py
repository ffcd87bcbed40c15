"""Image helpers of the ranking grids, without OpenCV or matplotlib
(the port's own copies of what ``bpbreid_tpu/utils/visualization/
rankings.py`` takes from them).

- ``JET``: OpenCV's ``COLORMAP_JET`` table as RGB, ``[256, 3]`` uint8,
  carried as data (``cv2.applyColorMap`` of the 256 levels, after the
  BGR -> RGB swap).
- ``hsv_colormap``: matplotlib's ``hsv`` colormap (its segment table,
  made into matplotlib's 256-entry lookup table the way
  ``LinearSegmentedColormap`` does), ``TAB10`` and ``TAB20``,
  matplotlib's ``tab10`` and ``tab20`` colours, and ``listed_colors``,
  their lookup as ``imshow`` and ``scatter`` do it (the values scaled to
  their own min and max first); ``NAMED`` the named colours the grids
  use, with matplotlib's values (``'green'`` is ``(0, 128, 0)``).
- ``resize_cubic`` and ``resize_nearest``: ``cv2.resize`` with
  ``INTER_CUBIC`` (float maps: coefficient -0.75, taps outside the map
  clamped to its edge, float32 sums) and ``INTER_NEAREST``.
- ``fill_rect`` and ``draw_marker``: the bars and the scatter markers of
  the figures that matplotlib draws in the JAX package.
"""
import numpy as np

__all__ = ['JET', 'TAB10', 'TAB20', 'NAMED', 'hsv_colormap',
           'listed_colors', 'to_uint8_rgb', 'resize_cubic', 'resize_nearest',
           'fill_rect', 'draw_marker']

JET = np.frombuffer(bytes.fromhex(
    '00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac'
    '0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc'
    '0000e00000e40000e80000ec0000f00000f40000f80000fc0000ff0004ff0008ff000cff'
    '0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff'
    '0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff'
    '0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff'
    '00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff'
    '00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff'
    '02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd2'
    '32ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa2'
    '62ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff72'
    '92ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42'
    'c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12'
    'f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00ffe800ffe400ffe000'
    'ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000'
    'ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000'
    'ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000'
    'ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000'
    'ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000'
    'ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000'
    'bc0000b80000b40000b00000ac0000a80000a40000a000009c0000980000940000900000'
    '8c0000880000840000800000'), np.uint8).reshape(256, 3)

# matplotlib's _cm._hsv_data: (x, y0, y1) per channel
_HSV_SEGMENTS = {
    'red': (
        (0.0, 1.0, 1.0), (0.15873, 1.0, 1.0), (0.174603, 0.96875, 0.96875),
        (0.333333, 0.03125, 0.03125), (0.349206, 0.0, 0.0),
        (0.666667, 0.0, 0.0), (0.68254, 0.03125, 0.03125),
        (0.84127, 0.96875, 0.96875), (0.857143, 1.0, 1.0), (1.0, 1.0, 1.0)),
    'green': (
        (0.0, 0.0, 0.0), (0.15873, 0.9375, 0.9375), (0.174603, 1.0, 1.0),
        (0.507937, 1.0, 1.0), (0.666667, 0.0625, 0.0625), (0.68254, 0.0, 0.0),
        (1.0, 0.0, 0.0)),
    'blue': (
        (0.0, 0.0, 0.0), (0.333333, 0.0, 0.0), (0.349206, 0.0625, 0.0625),
        (0.507937, 1.0, 1.0), (0.84127, 1.0, 1.0), (0.857143, 0.9375, 0.9375),
        (1.0, 0.09375, 0.09375)),
}

TAB10 = (
    (0.12156862745098039, 0.4666666666666667, 0.7058823529411765),
    (1.0, 0.4980392156862745, 0.054901960784313725),
    (0.17254901960784313, 0.6274509803921569, 0.17254901960784313),
    (0.8392156862745098, 0.15294117647058825, 0.1568627450980392),
    (0.5803921568627451, 0.403921568627451, 0.7411764705882353),
    (0.5490196078431373, 0.33725490196078434, 0.29411764705882354),
    (0.8901960784313725, 0.4666666666666667, 0.7607843137254902),
    (0.4980392156862745, 0.4980392156862745, 0.4980392156862745),
    (0.7372549019607844, 0.7411764705882353, 0.13333333333333333),
    (0.09019607843137255, 0.7450980392156863, 0.8117647058823529),
)

# matplotlib's _cm._tab20_data
TAB20 = tuple(tuple(int(h[i:i + 2], 16) / 255 for i in (0, 2, 4)) for h in (
    '1f77b4', 'aec7e8', 'ff7f0e', 'ffbb78', '2ca02c', '98df8a', 'd62728',
    'ff9896', '9467bd', 'c5b0d5', '8c564b', 'c49c94', 'e377c2', 'f7b6d2',
    '7f7f7f', 'c7c7c7', 'bcbd22', 'dbdb8d', '17becf', '9edae5'))

NAMED = {'red': (1.0, 0.0, 0.0), 'green': (0.0, 128 / 255, 0.0),
         'blue': (0.0, 0.0, 1.0), 'black': (0.0, 0.0, 0.0)}

_LUT_SIZE = 256


def _lookup_table(segments, n=_LUT_SIZE):
    """matplotlib's ``colors._create_lookup_table`` (gamma 1)."""
    a = np.asarray(segments, np.float64)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


_HSV_LUT = np.stack([_lookup_table(_HSV_SEGMENTS[c])
                     for c in ('red', 'green', 'blue')], axis=1)


def hsv_colormap(x):
    """``matplotlib.colormaps['hsv'](x)[:3]`` for x in [0, 1]: the
    lookup-table entry ``int(x * 256)`` (255 at x = 1)."""
    i = min(max(int(float(x) * _LUT_SIZE), 0), _LUT_SIZE - 1)
    return tuple(float(v) for v in _HSV_LUT[i])


def listed_colors(values, table):
    """RGB uint8 ``[..., 3]`` of ``values`` through a listed colormap
    (``TAB10``, ``TAB20``) as matplotlib's ``imshow`` and ``scatter`` map
    them: scaled to ``[0, 1]`` by their own min and max (all 0 when they
    are equal), then entry ``int(v * N)``, ``N - 1`` at ``v = 1``."""
    v = np.asarray(values, np.float64)
    lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 0.0)
    v = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    idx = np.clip((v * len(table)).astype(np.int64), 0, len(table) - 1)
    return np.round(np.asarray(table, np.float64)[idx] * 255).astype(np.uint8)


def to_uint8_rgb(color):
    """An RGB colour of floats in [0, 1] (or a name of ``NAMED``) as
    uint8."""
    if isinstance(color, str):
        color = NAMED[color]
    return np.round(np.asarray(color[:3], np.float64) * 255).astype(np.uint8)


def _cubic_taps(dst, src):
    """OpenCV's ``INTER_CUBIC`` taps: source index and float32 weights of
    each output coordinate; indices outside the source clamped."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f)
    x = f - s
    a, one = np.float32(-0.75), np.float32(1)
    x1, x2 = x + one, one - x
    c0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * x2 - (a + 3)) * x2 * x2 + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, src - 1)
    return idx, (c0, c1, c2, c3)


def resize_cubic(img, height, width):
    """``cv2.resize(img, (width, height), interpolation=INTER_CUBIC)`` for
    float ``[H, W]`` or ``[H, W, C]`` maps (float32 result): the
    horizontal pass then the vertical one, each a float32 sum of four
    taps in order."""
    src = np.asarray(img, np.float32)
    ix, cx = _cubic_taps(width, src.shape[1])
    iy, cy = _cubic_taps(height, src.shape[0])
    extra = (None,) * (src.ndim - 2)
    rows = np.zeros((src.shape[0], width) + src.shape[2:], np.float32)
    for k in range(4):
        rows = rows + src[:, ix[:, k]] * cx[k][(None, slice(None)) + extra]
    out = np.zeros((height,) + rows.shape[1:], np.float32)
    for k in range(4):
        out = out + rows[iy[:, k]] * cy[k][(slice(None), None) + extra]
    return out


def resize_nearest(img, height, width):
    """``cv2.resize(img, (width, height), interpolation=INTER_NEAREST)``:
    source index ``floor(d * (1 / (dst / src)))``, clamped."""
    h_in, w_in = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w_in)))
                    .astype(np.int64), w_in - 1)
    sy = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h_in)))
                    .astype(np.int64), h_in - 1)
    return img[sy[:, None], sx[None, :]]


def fill_rect(canvas, y0, y1, x0, x1, color):
    """Fill rows ``[y0, y1)`` and columns ``[x0, x1)`` of an ``[H, W, 3]``
    uint8 canvas with ``color`` (RGB floats or a name), clipped to it."""
    h, w = canvas.shape[:2]
    y0, y1 = max(int(y0), 0), min(int(y1), h)
    x0, x1 = max(int(x0), 0), min(int(x1), w)
    if y1 > y0 and x1 > x0:
        canvas[y0:y1, x0:x1] = to_uint8_rgb(color)


def draw_marker(canvas, y, x, rgb, kind='o', radius=2, alpha=1.0):
    """A scatter marker centred on pixel ``(y, x)``: a filled disc
    (``'o'``) or a diagonal cross (``'x'``) of ``radius`` pixels in the
    uint8 colour ``rgb``, blended over the canvas with ``alpha``; the
    parts off the canvas are dropped."""
    h, w = canvas.shape[:2]
    r = int(radius)
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    if kind == 'o':
        on = dy ** 2 + dx ** 2 <= r * r + r
    elif kind == 'x':
        on = np.abs(dy) == np.abs(dx)
    else:
        raise ValueError('marker {!r} is not drawn (o or x)'.format(kind))
    ys, xs = dy[on] + int(round(y)), dx[on] + int(round(x))
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    ys, xs = ys[keep], xs[keep]
    old = canvas[ys, xs].astype(np.float64)
    canvas[ys, xs] = np.round(
        old * (1 - alpha) + np.asarray(rgb, np.float64)[:3] * alpha
    ).astype(np.uint8)
