"""Video triplet engine (port of bpbreid_tpu/engine/video/triplet.py):
the image triplet + CE engine on tracklets, flattened for training and
pooled at eval as in ``VideoSoftmaxEngine``."""
from bpbreid_tpu_torch.engine.image.triplet import ImageTripletEngine
from bpbreid_tpu_torch.engine.video.softmax import TrackletEngine

__all__ = ['VideoTripletEngine']


class VideoTripletEngine(TrackletEngine, ImageTripletEngine):
    """Args as ``ImageTripletEngine``'s, and ``pooling_method``."""

    def __init__(self, datamanager, model, optimizer=None, margin=0.3,
                 weight_t=1.0, weight_x=1.0, scheduler=None,
                 label_smooth=True, pooling_method='avg', config=None,
                 writer=None, engine_state=None, save_model_flag=False,
                 device=None):
        super().__init__(datamanager, model, optimizer, margin=margin,
                         weight_t=weight_t, weight_x=weight_x,
                         scheduler=scheduler, label_smooth=label_smooth,
                         config=config, writer=writer,
                         engine_state=engine_state,
                         save_model_flag=save_model_flag, device=device)
        self.set_pooling_method(pooling_method)
