"""Plain-PyTorch train step of BPBReID: the shipped ``rc re``
augmentation, the PifPaf ``five_v`` part masks, the GiLt losses with the
body-part attention loss, and Adam (float32; the caller turns TF32 off).

The random draws of an augmentation are taken from a ``torch.Generator``
that the caller seeds as it seeds the program's: the same calls in the
same order (``draws``), so both sides crop and erase alike without either
reading the other's tensors.

Departures from the published training recipe: the random crop pads by
10 pixels and crops back (the reference repo's ``RandomCrop`` pads the
same way); the erase fills with the normalization mean; the masks follow
the image through the crop and the erase at full resolution and are then
grouped, given a background and downscaled to the feature grid.
"""
import torch
import torch.nn.functional as F

from benchmark.reference.masks import group_masks

__all__ = ['draws', 'augment', 'eval_images', 'gilt_loss', 'Adam',
           'train_step']

PAD = 10
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def draws(generator, n, h, w, transforms):
    """Crop offsets ``[n, 2]`` in the padded grid and the erase rectangles
    ``(apply, y0, x0, hh, hw)``, in the order the program draws them."""
    unknown = set(transforms) - {'rc', 're'}
    if unknown:
        raise ValueError('the reference augments with rc and re only, not '
                         '{}'.format(sorted(unknown)))
    dev = generator.device
    out = {'off': None, 'erase': None}
    if 'rc' in transforms:
        out['off'] = torch.randint(0, 2 * PAD + 1, (n, 2),
                                   generator=generator, device=dev)
    if 're' in transforms:
        apply = torch.rand(n, generator=generator, device=dev) < 0.5
        hh = torch.randint(int(h * 0.15), int(h * 0.65) + 1, (n,),
                           generator=generator, device=dev)
        hw = torch.randint(int(w * 0.15), int(w * 0.65) + 1, (n,),
                           generator=generator, device=dev)
        y0 = torch.randint(0, h, (n,), generator=generator, device=dev)
        x0 = torch.randint(0, w, (n,), generator=generator, device=dev)
        out['erase'] = (apply, torch.minimum(y0, h - hh),
                        torch.minimum(x0, w - hw), hh, hw)
    return out


def _crop(x, off):
    """Zero-pad ``[N, C, H, W]`` by PAD and crop back at ``off``."""
    n, _, h, w = x.shape
    xp = F.pad(x, (PAD, PAD, PAD, PAD))
    return torch.stack([xp[i, :, o[0]:o[0] + h, o[1]:o[1] + w]
                        for i, o in enumerate(off.tolist())])


def _erase_mask(erase, n, h, w, device):
    """``[N, 1, H, W]`` True inside each applied rectangle."""
    apply, y0, x0, hh, hw = (t.to(device) for t in erase)
    yy = torch.arange(h, device=device)[None, :, None]
    xx = torch.arange(w, device=device)[None, None, :]
    inside = ((yy >= y0[:, None, None]) & (yy < (y0 + hh)[:, None, None])
              & (xx >= x0[:, None, None]) & (xx < (x0 + hw)[:, None, None])
              & apply[:, None, None])
    return inside[:, None]


def eval_images(images_u8):
    """uint8 ``[N, H, W, 3]`` -> normalized float ``[N, 3, H, W]``."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    mean = torch.tensor(MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def augment(images_u8, fields, d, masks_cfg):
    """The augmented, normalized images ``[N, 3, H, W]`` and their part
    masks ``[N, K+1, H/s, W/s]`` (background first) from uint8 images
    ``[N, H, W, 3]``, PifPaf fields ``[N, h, w, 36]`` and the draws ``d``."""
    n, h, w, _ = images_u8.shape
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    m = F.interpolate(fields.permute(0, 3, 1, 2).float(), size=(h, w),
                      mode='bilinear', align_corners=False)
    if d['off'] is not None:
        x, m = _crop(x, d['off']), _crop(m, d['off'])
    mean = torch.tensor(MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(STD, device=x.device)[None, :, None, None]
    x = (x - mean) / std
    if d['erase'] is not None:
        inside = _erase_mask(d['erase'], n, h, w, x.device)
        x = torch.where(inside, mean.expand_as(x), x)
        m = torch.where(inside, torch.zeros_like(m), m)
    parts = group_masks(m, masks_cfg['preprocess'])
    background = (parts.amax(dim=1, keepdim=True)
                  < masks_cfg['mask_filtering_threshold']).float()
    full = torch.softmax(torch.cat([background, parts], dim=1)
                         * masks_cfg['softmax_weight'], dim=1)
    s = masks_cfg['mask_scale']
    return x, F.interpolate(full, size=(h // s, w // s), mode='nearest')


def _smoothed_ce(logits, targets, eps=0.1):
    """Label-smoothing cross entropy over the last axis, mean over rows."""
    c = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    onehot = (targets[:, None] == torch.arange(c, device=logits.device))
    smooth = (1.0 - eps) * onehot.float() + eps / c
    return -(smooth * logp).sum(dim=-1).mean()


def _part_averaged_triplet(emb, pids, margin):
    """Batch-hard triplet loss on the part-averaged euclidean distances of
    ``[N, K, D]`` embeddings (the GiLt paper's part-averaged loss)."""
    e = emb.transpose(0, 1)                                 # [K, N, D]
    sq = (e * e).sum(dim=-1)
    d2 = F.relu(sq[:, :, None] - 2.0 * e @ e.transpose(1, 2)
                + sq[:, None, :])
    zero = (d2 == 0).float()
    dist = (torch.sqrt(d2 + zero * 1e-16) * (1 - zero)).mean(dim=0)
    n = pids.shape[0]
    same = pids[:, None] == pids[None, :]
    pos = same & ~torch.eye(n, dtype=torch.bool, device=pids.device)
    hardest_pos = (dist * pos - (~pos).float()).amax(dim=-1)
    hardest_neg = (dist * ~same + same.float() * 1e16).amin(dim=-1)
    valid = (hardest_pos != -1.0) & (hardest_neg != 1e16)
    per = F.relu(hardest_pos - hardest_neg + margin) * valid
    return per.sum() / valid.sum().clamp(min=1)


def gilt_loss(out, masks, pids, weights, margin=0.3):
    """GiLt (identity cross entropy and part-averaged triplet per stream,
    weighted) plus the pixel-wise part classification loss on the masks'
    argmax at the feature grid. Returns the total and its weighted
    ``id``, ``triplet`` and ``pixel`` terms."""
    terms = {'id': 0.0, 'triplet': 0.0}
    for key in ('globl', 'foreg', 'conct', 'parts'):
        w = weights[key]
        if w['id'] > 0:
            s = out['scores'][key]
            p = pids
            if s.dim() == 3:
                p = pids[:, None].expand(s.shape[:2]).reshape(-1)
                s = s.reshape(-1, s.shape[-1])
            terms['id'] = terms['id'] + w['id'] * _smoothed_ce(s, p)
    for key in ('globl', 'foreg', 'conct', 'parts'):
        w = weights[key]
        if w['tr'] > 0:
            e = out['emb'][key]
            e = e if e.dim() == 3 else e[:, None]
            terms['triplet'] = terms['triplet'] + w['tr'] * \
                _part_averaged_triplet(e, pids, margin)
    logits = out['pixel_logits']
    n, c, hf, wf = logits.shape
    target = F.interpolate(masks, size=(hf, wf), mode='bilinear',
                           align_corners=True) \
        if masks.shape[-2:] != (hf, wf) else masks
    target = target.argmax(dim=1).reshape(n, -1)
    ce = _smoothed_ce(logits.reshape(n, c, -1).transpose(1, 2)
                      .reshape(-1, c), target.reshape(-1))
    terms['pixel'] = weights['pixls']['ce'] * ce
    return terms['id'] + terms['triplet'] + terms['pixel'], terms


class Adam:
    """Adam (Kingma and Ba, 2015) with L2 weight decay added to the
    gradient, as ``torch.optim.Adam`` defines it; a parameter without a
    gradient gets a zero one."""

    def __init__(self, params, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8):
        self.params = list(params)
        self.lr, self.wd, self.eps = lr, weight_decay, eps
        self.b1, self.b2 = betas
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        """Returns the gradients as the update took them."""
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        taken = []
        for p, m, v in zip(self.params, self.m, self.v):
            g = (p.grad if p.grad is not None else torch.zeros_like(p)) \
                + self.wd * p
            taken.append(g)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / c1 * m / ((v / c2).sqrt() + self.eps))
        return taken


def train_step(model, opt, images_u8, fields, pids, d, config):
    """One reference train step; returns ``(loss, its terms, loss
    gradients by parameter, gradients the update took)``."""
    model.train()
    x, masks = augment(images_u8, fields, d, config['masks'])
    out = model(x)
    loss, terms = gilt_loss(out, masks, pids, config['loss']['weights'],
                     config['loss']['margin'])
    for p in opt.params:
        p.grad = None
    loss.backward()
    grads = [None if p.grad is None else p.grad.detach().clone()
             for p in opt.params]
    taken = opt.step()
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in terms.items()}, grads, taken)
