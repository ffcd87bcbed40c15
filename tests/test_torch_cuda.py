"""bpbreid_tpu_torch kernels on the card (marker ``cuda``; skipped
without a CUDA device). Run on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -m cuda``.

The attention-pool kernel is held against its plain version on the
same CUDA inputs: f32 sums over the pixels in another order, so the
tolerance is 2e-5 of the largest output magnitude."""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('shape', [(2, 40, 7, 1, 3), (3, 100, 96, 32, 37),
                                   (64, 1920, 96, 32, 6), (1, 7, 13, 11, 64)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_attention_pool_kernel_matches_plain(cuda, shape, dtype):
    from bpbreid_tpu_torch.ops.cuda.build import launch_counts
    from bpbreid_tpu_torch.ops.cuda.pooling import (attention_pool_reference,
                                                    fused_attention_pool)
    n, d, h, w, k1 = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    feats = torch.randn(n, d, h, w, device=cuda, generator=gen).to(dtype)
    logits = (3 * torch.randn(n, k1, h, w, device=cuda, generator=gen)) \
        .to(dtype)
    before = launch_counts['attention_pool']
    got = fused_attention_pool(feats, logits)
    torch.cuda.synchronize()
    assert launch_counts['attention_pool'] == before + 1
    for a, b in zip(got, attention_pool_reference(feats, logits)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        tol = 2e-5 * b.abs().max().item() + 1e-6
        assert (a - b).abs().max().item() <= tol


def test_attention_pool_kernel_refuses_bad_cuda_inputs(cuda):
    from bpbreid_tpu_torch.ops.cuda.pooling import fused_attention_pool
    feats = torch.zeros(2, 8, 4, 4, device=cuda)
    with pytest.raises(ValueError):         # not contiguous: no copy made
        fused_attention_pool(feats.transpose(2, 3),
                             torch.zeros(2, 3, 4, 4, device=cuda))
    with pytest.raises(TypeError):
        fused_attention_pool(feats.half(), torch.zeros(2, 3, 4, 4,
                                                       device=cuda))
    with pytest.raises(ValueError):
        fused_attention_pool(feats, torch.zeros(2, 65, 4, 4, device=cuda))
