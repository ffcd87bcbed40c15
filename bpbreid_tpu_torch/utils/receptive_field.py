"""Analytic receptive fields of a stack of convolutions (port of
bpbreid_tpu/utils/receptive_field.py; the reference's
torchreid/utils/torch_receptive_field/receptive_field.py): the layers
are given as a ``(kernel, stride, padding)`` list, with the lists of the
built-in backbones' trunks."""
__all__ = ['compute_receptive_field', 'RESNET50_SPEC', 'HRNET_STEM_SPEC']

# (kernel, stride, padding) per sequential stage
RESNET50_SPEC = [(7, 2, 3), (3, 2, 1)] + [(3, 1, 1)] * 3 \
    + [(3, 2, 1)] + [(3, 1, 1)] * 3 \
    + [(3, 2, 1)] + [(3, 1, 1)] * 5 \
    + [(3, 1, 1)] + [(3, 1, 1)] * 2   # last_stride=1 variant
HRNET_STEM_SPEC = [(3, 2, 1), (3, 2, 1)]


def compute_receptive_field(spec):
    """Propagate (rf, jump, start) through a list of (k, s, p) layers.

    Returns a list of dicts per layer with ``rf`` (receptive field size),
    ``jump`` (output stride) and ``start`` (center offset of the first
    output feature in input coords).
    """
    rf, jump, start = 1, 1, 0.5
    out = []
    for k, s, p in spec:
        rf = rf + (k - 1) * jump
        start = start + ((k - 1) / 2 - p) * jump
        jump = jump * s
        out.append({'k': k, 's': s, 'p': p, 'rf': rf, 'jump': jump,
                    'start': start})
    return out
