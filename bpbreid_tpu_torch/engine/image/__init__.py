from bpbreid_tpu_torch.engine.image.softmax import ImageSoftmaxEngine
from bpbreid_tpu_torch.engine.image.triplet import ImageTripletEngine

__all__ = ['ImageSoftmaxEngine', 'ImageTripletEngine']
