"""Out-of-band collectives (counterpart of ``ray_tpu/util/collective/``):
gloo for host tensors (``"tcp"``) and NCCL for device tensors
(``"nccl"``), one rank per process, and the cards of one process as the
ranks (``"mesh"``, ``CudaMeshGroup``); each group supervised (sequence
numbers, flight recorder, watchdog abort)."""

from ray_tpu_torch.util.collective.collective import (  # noqa: F401
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    flight_recorder_dump,
    get_collective_group_size,
    get_group_state,
    get_rank,
    init_collective_group,
    is_group_initialized,
    permute,
    recv,
    reduce,
    reducescatter,
    send,
)
from ray_tpu_torch.util.collective.collective_group.base_collective_group import (  # noqa: F401,E501
    BaseGroup,
)
from ray_tpu_torch.util.collective.collective_group.mesh_group import (  # noqa: F401,E501
    CudaMeshGroup,
)
from ray_tpu_torch.util.collective.collective_group.torch_group import (  # noqa: F401,E501
    TorchDistributedGroup,
)
from ray_tpu_torch.util.collective.types import (  # noqa: F401
    Backend,
    GroupState,
    ReduceOp,
)
