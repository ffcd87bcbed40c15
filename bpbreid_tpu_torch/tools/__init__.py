from bpbreid_tpu_torch.tools.feature_extractor import FeatureExtractor
from bpbreid_tpu_torch.tools.extract_part_based_features import \
    extract_reid_features

__all__ = ['FeatureExtractor', 'extract_reid_features']
