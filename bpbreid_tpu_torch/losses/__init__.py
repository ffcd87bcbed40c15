"""Losses of the part-based train step (port of bpbreid_tpu/losses/)."""
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
           'init_part_based_triplet_loss']
