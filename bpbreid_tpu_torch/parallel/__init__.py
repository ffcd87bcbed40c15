from bpbreid_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    make_mesh,
    replicate,
    shard_array,
    shard_batch_spec,
)
from bpbreid_tpu_torch.parallel.retrieval import (
    pad_to_multiple,
    sharded_bp_distance,
    sharded_cmc_map,
)
from bpbreid_tpu_torch.parallel.train import distribute_engine
