from torchmdnet_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from torchmdnet_tpu_torch.parallel.edge_partition import (  # noqa: F401
    edge_sharded_apply,
    shard_batch_by_atoms,
    sharded_gather_aggregate,
    two_stage_molecular_reduce,
)
