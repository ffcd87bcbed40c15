"""Global-embedding triplet + cross-entropy engine (port of
bpbreid_tpu/engine/image/triplet.py).

The softmax engine with the loss ``weight_t * batch-hard triplet (the
embedding) + weight_x * label-smoothed CE (the class scores)``; the
model returns ``(scores, embedding)`` in train mode (``loss='triplet'``).
"""
from bpbreid_tpu_torch.engine.image.softmax import ImageSoftmaxEngine
from bpbreid_tpu_torch.losses.cross_entropy import CrossEntropyLoss
from bpbreid_tpu_torch.losses.triplet import TripletLoss

__all__ = ['ImageTripletEngine']


class ImageTripletEngine(ImageSoftmaxEngine):
    """Args as ``ImageSoftmaxEngine``'s, and ``margin``, ``weight_t`` and
    ``weight_x`` (each >= 0, not both 0)."""
    loss_mode = 'triplet'

    def __init__(self, datamanager, model, optimizer=None, margin=0.3,
                 weight_t=1.0, weight_x=1.0, scheduler=None,
                 label_smooth=True, config=None, writer=None,
                 engine_state=None, save_model_flag=False, device=None):
        super().__init__(datamanager, model, optimizer, scheduler=scheduler,
                         label_smooth=label_smooth, config=config,
                         writer=writer, engine_state=engine_state,
                         save_model_flag=save_model_flag, device=device)
        if weight_t < 0 or weight_x < 0 or weight_t + weight_x <= 0:
            raise ValueError('weight_t and weight_x must be >= 0 and not '
                             'both 0, got {} and {}'.format(weight_t,
                                                            weight_x))
        self.weight_t, self.weight_x = weight_t, weight_x
        self.criterion_t = TripletLoss(margin=margin)
        self.criterion_x = CrossEntropyLoss(label_smooth=label_smooth)

    def compute_loss(self, outputs, pids):
        """(``_compute_loss`` :31)"""
        logits, features = outputs
        loss, summary = 0.0, {}
        if self.weight_t > 0:
            loss_t = self.criterion_t(features, pids)
            loss = loss + self.weight_t * loss_t
            summary['t'] = loss_t.detach()
        if self.weight_x > 0:
            loss_x = self.criterion_x(logits, pids)
            loss = loss + self.weight_x * loss_x
            summary['x'] = loss_x.detach()
            summary['acc'] = (logits.argmax(dim=-1) == pids).float().mean()
        return loss, {'triplet': summary}
