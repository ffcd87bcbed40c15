"""Losses of the train steps (port of bpbreid_tpu/losses/)."""
from bpbreid_tpu_torch.losses.bpa import BodyPartAttentionLoss
from bpbreid_tpu_torch.losses.cross_entropy import (CrossEntropyLoss,
                                                    cross_entropy_loss)
from bpbreid_tpu_torch.losses.gilt import GiLtLoss
from bpbreid_tpu_torch.losses.triplet import (
    InterPartsTripletLoss, PartAveragedTripletLoss, PartIndividualTripletLoss,
    PartMaxMinTripletLoss, PartMaxTripletLoss, PartMinTripletLoss,
    PartRandomMaxMinTripletLoss, TripletLoss, init_part_based_triplet_loss)

__all__ = ['BodyPartAttentionLoss', 'CrossEntropyLoss', 'cross_entropy_loss',
           'GiLtLoss', 'InterPartsTripletLoss', 'PartAveragedTripletLoss',
           'PartIndividualTripletLoss', 'PartMaxMinTripletLoss',
           'PartMaxTripletLoss', 'PartMinTripletLoss',
           'PartRandomMaxMinTripletLoss', 'TripletLoss',
           'deep_supervision', 'init_part_based_triplet_loss']


def deep_supervision(criterion, xs, y):
    """``criterion`` on each output of ``xs`` against ``y``, averaged
    (JAX ``deep_supervision``; torchreid's ``DeepSupervision``): the loss of
    a model with several heads (PCB's strips, HACNN's global and local
    branches)."""
    total = 0.0
    for x in xs:
        total = total + criterion(x, y)
    return total / len(xs)
