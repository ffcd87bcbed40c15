"""Top-k classification accuracy (port of bpbreid_tpu/metrics/accuracy.py)."""
import torch

__all__ = ['accuracy']


def accuracy(output, target, topk=(1,)):
    """Accuracy over the k top predictions.

    Args:
        output: ``[N, num_classes]`` prediction scores.
        target: ``[N]`` integer labels.
        topk: tuple of k values.

    Returns:
        list of accuracies (floats in [0, 100]), one per k. Tied scores
        rank by class index, as JAX's stable ``argsort(-output)`` does
        (``torch.topk`` promises no order among ties).
    """
    output = torch.as_tensor(output)
    target = torch.as_tensor(target, device=output.device)
    maxk = max(topk)
    batch_size = target.shape[0]
    pred = torch.argsort(-output, dim=1, stable=True)[:, :maxk]  # [N, maxk]
    correct = pred == target[:, None]
    return [float(correct[:, :k].any(dim=1).sum()) / batch_size * 100.0
            for k in topk]
