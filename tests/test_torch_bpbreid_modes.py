"""bpbreid_tpu_torch BPBReID vs bpbreid_tpu: test-time target
segmentation (soft and hard, including the reference's view-write
quirk) and the bf16 compute dtype of the slice's fused-pool path.

Tolerances: f32 1e-3 for the whole model, boolean visibility exact;
bf16 5e-2 relative on embeddings (bf16 rounds at every layer, in other
places in XLA and PyTorch) and at least 90% equal visibility flags (a
near-tie argmax can flip under other rounding)."""
import numpy as np
import pytest
import torch

from bpbreid_tpu_torch.constants import BN_FOREGROUND, PARTS
from tests.test_torch_bpbreid import assert_outputs_match, inputs, run_both
from tests.torch_port_helpers import to_np, limit_torch_threads

limit_torch_threads()

__all__ = ['inputs']


@pytest.mark.parametrize('mode', ['hard', 'soft'])
def test_target_segmentation_matches_jax(inputs, mode):
    want, got = run_both(inputs, test_use_target_segmentation=mode,
                         use_pallas_pooling=True)
    # target segmentation bypasses both the multires path and the fused
    # kernel (its masks are no longer softmax(logits)), as in JAX
    assert got[4] is not None
    assert_outputs_match(want, got)


def test_fused_pool_path_bf16_close_to_jax(inputs):
    want, got = run_both(inputs, dtype='bfloat16', use_pallas_pooling=True,
                         multires_pooling=False)
    for key in (BN_FOREGROUND, PARTS):
        g = to_np(got[0][key])
        w = np.asarray(want[0][key], np.float32)
        assert got[0][key].dtype == torch.bfloat16
        assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), key
    agree = np.mean([np.mean(to_np(got[1][k]) == to_np(want[1][k]))
                     for k in want[1]])
    assert agree >= 0.9
