"""Data-parallel training and eval over processes, one a card, and
training over a model axis (counterpart of radzero_tpu/parallel): the process
groups (:mod:`.dist`), the collectives the loss, the step and the
row-parallel layers run (:mod:`.collectives`), and the tensor-parallel rules
(:mod:`.tensor_parallel`)."""

from radzero_torch.parallel.collectives import (
    all_gather_rows,
    all_reduce_sum,
    average_gradients,
    copy_to_model,
    gather_rows,
)
from radzero_torch.parallel.dist import (
    check_mesh,
    init_distributed,
    local_rank,
    mesh_groups,
    mesh_shape,
    process_offset,
    rank,
    sync,
    world,
)
from radzero_torch.parallel.tensor_parallel import (
    param_specs,
    split_leaves,
    shard_params,
    unshard_params,
)
