from bpbreid_tpu_torch.engine.video.softmax import VideoSoftmaxEngine
from bpbreid_tpu_torch.engine.video.triplet import VideoTripletEngine

__all__ = ['VideoSoftmaxEngine', 'VideoTripletEngine']
