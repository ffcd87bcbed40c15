"""bpbreid_tpu_torch: the PyTorch/CUDA port of bpbreid_tpu.

Eval, retrieval and the train step of BPBReID with an HRNet-W32
backbone, written in PyTorch for an NVIDIA Hopper GPU. Layout and names
mirror ``bpbreid_tpu`` (``models/hrnet.py``, ``ops/pooling.py``,
``losses/``, ...), so each module's JAX counterpart is found at the same
path. The Pallas TPU kernels on these paths (the attention pool of
``ops/pallas/pooling.py``; the train-mode BN sums of
``experiments/pallas_bn_*.py``) are hand-written CUDA kernels here
(``ops/cuda/``).

Tensors are channel-first (NCHW) inside the port; entry points take an
explicit ``device`` that defaults to ``'cuda'`` and raise when CUDA is
missing unless the caller asks for ``'cpu'``.
"""
import torch

__version__ = '0.1.0'


def resolve_device(device=None):
    """``device`` as a ``torch.device``; ``None`` means ``'cuda'``.

    Raises instead of falling back to the CPU when CUDA is requested
    but unavailable.
    """
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device
