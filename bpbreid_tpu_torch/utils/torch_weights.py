"""Torchreid checkpoints into the port (counterpart of
bpbreid_tpu/utils/torch_weights.py).

The port's modules carry the torch reference's parameter names, so a
torchreid ``state_dict`` loads key for key, with nothing transposed.
The load is partial and shape-checked, as the reference's
``load_pretrained_weights`` (torchreid/utils/torchtools.py:260-321): a
module tensor that the file lacks, or holds with another shape, keeps its
value; file keys the module does not have (``num_batches_tracked``, an
ImageNet classifier) are ignored.
"""
import numpy as np
import torch

__all__ = ['load_torch_state_dict', 'load_torchreid_state_dict']


def load_torch_state_dict(path):
    """Read a ``.pth`` / ``.pth.tar`` file on the CPU.

    Accepts a raw state dict or a torchreid checkpoint dict with a
    ``'state_dict'`` entry, and strips the ``module.`` prefix that
    ``DataParallel`` adds. The file is unpickled in full
    (``weights_only=False``): torchreid pickles numpy scalars and config
    objects beside the tensors. Only a file the user names comes here.

    Returns:
        ``(state_dict, extra)``: ``{key: tensor}`` and the checkpoint's
        non-tensor entries (``epoch``, ``rank1``, ``config``, ...).
    Raises:
        ModuleNotFoundError naming the missing package and the file, when
        unpickling needs a package that is not installed (yacs, for a
        config object the reference wrote).
    """
    try:
        ckpt = torch.load(path, map_location='cpu', weights_only=False)
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            "{} pickles objects of the package '{}', which is not installed"
            .format(path, e.name), name=e.name) from e
    sd = ckpt.get('state_dict', ckpt) if isinstance(ckpt, dict) else ckpt
    out = {}
    for k, v in sd.items():
        if k.startswith('module.'):
            k = k[len('module.'):]
        out[k] = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
    extra = {}
    if isinstance(ckpt, dict):
        extra = {k: v for k, v in ckpt.items() if k != 'state_dict'
                 and not isinstance(v, torch.Tensor)}
    return out, extra


@torch.no_grad()
def load_torchreid_state_dict(module, state_dict, strict=False):
    """Copy ``state_dict`` into ``module``'s parameters and buffers, each
    tensor once, into the module's own device and dtype.

    Returns:
        ``(matched, discarded)``: the module keys loaded from the file,
        and those left at their value (absent from the file, or of
        another shape there).
    Raises:
        KeyError / ValueError with ``strict``, at the first module key the
        file lacks or holds with another shape.
    """
    matched, discarded = [], []
    for key, target in module.state_dict().items():
        src = state_dict.get(key)
        if src is None:
            if strict:
                raise KeyError('missing key in the state dict: {}'.format(
                    key))
        elif tuple(src.shape) != tuple(target.shape):
            if strict:
                raise ValueError('shape mismatch for {}: file {} vs module '
                                 '{}'.format(key, tuple(src.shape),
                                             tuple(target.shape)))
        else:
            target.copy_(src)
            matched.append(key)
            continue
        discarded.append(key)
    return matched, discarded
