from bpbreid_tpu_torch.data.data_augmentation.random_occlusion import (
    OccluderBank, RandomOcclusion)

__all__ = ['OccluderBank', 'RandomOcclusion']
