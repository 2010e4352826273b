"""Data-parallel training and eval over processes, one a card (counterpart
of radzero_tpu/parallel): the process group (:mod:`.dist`) and the
collectives the loss and the step run (:mod:`.collectives`)."""

from radzero_torch.parallel.collectives import (
    all_gather_rows,
    average_gradients,
    gather_rows,
)
from radzero_torch.parallel.dist import (
    check_mesh,
    init_distributed,
    local_rank,
    process_offset,
    rank,
    sync,
    world,
)
