"""Seeded inputs: person crops and their PifPaf confidence fields.

Each batch holds ``ids`` identities drawn from the configuration's
classes with ``instances`` crops each; a crop is its identity's random
template plus noise of +-20 levels, so crops of one identity look alike.
The fields are uniform in [0, 1] at 1/``fields_stride`` of the image
grid, ``channels`` of them (36 PifPaf fields). Everything is drawn on the
device in a few calls from one ``torch.Generator``, so a seed gives the
same inputs on every run."""
import torch

__all__ = ['make_batches']


def make_batches(seed, n_batches, workload, config, device):
    """``(images uint8 [n, B, H, W, 3], fields f32 [n, B, h, w, C],
    pids int64 [n, B])`` on ``device``."""
    m = config['model']
    ids, inst = workload['ids'], workload['instances']
    h, w = m['height'], m['width']
    s, c = config['masks']['fields_stride'], config['masks']['fields_channels']
    g = torch.Generator(device=device).manual_seed(int(seed))
    pids = torch.stack([torch.randperm(m['num_classes'], generator=g,
                                       device=device)[:ids]
                        for _ in range(n_batches)])
    pids = pids.repeat_interleave(inst, dim=1)
    base = torch.randint(0, 256, (n_batches, ids, h, w, 3), generator=g,
                         device=device, dtype=torch.int16)
    noise = torch.randint(-20, 21, (n_batches, ids * inst, h, w, 3),
                          generator=g, device=device, dtype=torch.int16)
    images = (base.repeat_interleave(inst, dim=1) + noise).clamp_(0, 255) \
        .to(torch.uint8)
    fields = torch.rand(n_batches, ids * inst, h // s, w // s, c,
                        generator=g, device=device)
    return images, fields, pids
