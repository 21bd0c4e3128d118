"""Parallelism over ``torch.distributed``: device meshes, logical-axis
sharding as DTensor placements, the pipeline schedule.

Counterpart of ``ray_tpu/parallel/``.  Every strategy (DP, FSDP, TP, SP,
PP, EP) is a layout over one ``DeviceMesh`` with the reference's five
named axes: params are DTensors placed by a logical-axis rule table, and
the model code stays a global-view program in which DTensor inserts the
collectives (all-gathers, reduce-scatters, all-reduces) and the ring and
pipeline paths send point to point.
"""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    MESH_AXES,
    MESH_PRESETS,
    MeshConfig,
    create_hybrid_mesh,
    create_mesh,
    ensure_process_group,
    local_mesh,
    mesh_shape_for,
    resolve_mesh_config,
)
from ray_tpu_torch.parallel.overlap import (  # noqa: F401
    OVERLAP_CUDA_FLAGS,
    ensure_collective_overlap,
    overlap_active,
)
from ray_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    pipeline_microbatches,
    pp_size,
    reject_pp,
)
from ray_tpu_torch.parallel.redistributes import (  # noqa: F401
    count_implicit_redistributes,
    redistribute_capture,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ENV_LEGACY_SHARDING,
    TP_INFERENCE_RULES,
    LogicalAxisRules,
    as_global,
    legacy_sharding_enabled,
    logical_to_placements,
    shard_tree,
    spec_tree_to_placements,
    with_logical_constraint,
    with_named_sharding,
)
