"""Hyper-parameter search (port of bpbreid_tpu/hyperparameter/)."""
from bpbreid_tpu_torch.hyperparameter.optimizer import (
    GridSearch,
    HyperParameterOptimizer,
    RandomSearch,
)
from bpbreid_tpu_torch.hyperparameter.clearml_service import (
    ClearMLServiceOptimizer,
    clearml_available,
    clone_task_with_overrides,
)
