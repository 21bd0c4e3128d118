"""ray_tpu_torch.workflow: durable DAG runs with storage-backed
checkpoints (counterpart of ``ray_tpu/workflow/``).

A workflow's steps are the classic-DAG function nodes of
``ray_tpu_torch.dag``; each step's result is checkpointed under
``{storage}/{workflow_id}/steps/{step_id}.pkl``, keyed by a content hash
of the step's function and its upstream lineage, so ``resume`` runs only
what is missing.
"""

from ray_tpu_torch.workflow.api import (
    WorkflowStatus,
    delete,
    get_metadata,
    get_output,
    get_status,
    list_all,
    resume,
    run,
    run_async,
)

__all__ = [
    "WorkflowStatus", "delete", "get_metadata", "get_output", "get_status",
    "list_all", "resume", "run", "run_async",
]
