"""Device meshes over ``torch.distributed``: the counterpart of
``ray_tpu/parallel/mesh.py``.

The mesh has the reference's five named axes, outermost to innermost:

    ("dp", "fsdp", "pp", "tp", "sp")

- ``dp``:   pure data parallelism (params replicated, grads summed)
- ``fsdp``: ZeRO-style sharded data parallelism (params and optimizer
            state sharded, gathered for compute)
- ``pp``:   pipeline parallelism (stacked layers sharded by stage;
            ``parallel/pipeline.py``)
- ``tp``:   tensor parallelism (Megatron-style column/row sharding)
- ``sp``:   sequence parallelism (ring attention, ``ops/attention.py``)

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, one rank per card, ranks laid out row-major over the axes:
the innermost axes get neighbouring ranks, which on one node are the
cards of one NVLink domain.  ``create_hybrid_mesh`` puts ``dp`` over the
nodes and the rest over one node's cards.  The backend is NCCL on CUDA
and gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MESH_AXES: Tuple[str, ...] = ("dp", "fsdp", "pp", "tp", "sp")

# the variables a launcher sets for each rank (torchrun's names)
_DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each mesh axis; -1 on at most one axis means "infer".

    ``MeshConfig(dp=-1, tp=4)`` on 16 devices → (4, 1, 1, 4, 1).
    """

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1

    def _sizes(self) -> Dict[str, int]:
        return {"dp": self.dp, "fsdp": self.fsdp, "pp": self.pp,
                "tp": self.tp, "sp": self.sp}

    def _named(self, only_fixed: bool = False) -> str:
        """Human-readable axis sizes, e.g. "dp=2, tp=4"."""
        items = [(a, s) for a, s in self._sizes().items()
                 if not (only_fixed and s in (1, -1))]
        return ", ".join(f"{a}={s}" for a, s in items) or "all axes = 1"

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int, int]:
        sizes = self._sizes()
        for axis, s in sizes.items():
            if s != -1 and s < 1:
                raise ValueError(
                    f"mesh axis {axis!r}={s} is invalid: sizes must be a "
                    "positive int, or -1 on at most one axis to infer it")
        infer = [a for a, s in sizes.items() if s == -1]
        if len(infer) > 1:
            raise ValueError(
                "at most one mesh axis may be -1 (inferred), got "
                + ", ".join(f"{a}=-1" for a in infer))
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if infer:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"cannot infer mesh axis {infer[0]!r}: {n_devices} "
                    f"devices not divisible by the fixed axes "
                    f"({self._named(only_fixed=True)}; product {fixed}); "
                    f"use MeshConfig.clamp_to({n_devices}) to degrade "
                    "gracefully")
            sizes[infer[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh ({self._named()}) needs {fixed} devices, have "
                f"{n_devices}; use MeshConfig.clamp_to({n_devices}) to "
                "degrade gracefully")
        return tuple(sizes[a] for a in MESH_AXES)  # type: ignore[return-value]

    def clamp_to(self, n_devices: int) -> "MeshConfig":
        """Degrade this mesh request to fit ``n_devices``, never raising
        on divisibility: the concrete config it returns always resolves.

        Model axes keep their requested size preferentially (clamp order
        tp → sp → pp → fsdp → dp, innermost first); each fixed axis is
        reduced to the largest size ≤ its request that divides the
        remaining device budget.  An inferred (-1) axis absorbs whatever
        remains; with no inferred axis, leftover devices fold into ``dp``.
        """
        if n_devices < 1:
            raise ValueError(f"clamp_to needs >= 1 device, got {n_devices}")
        sizes = self._sizes()
        infer = [a for a, s in sizes.items() if s == -1]
        if len(infer) > 1:
            raise ValueError(
                "at most one mesh axis may be -1 (inferred), got "
                + ", ".join(f"{a}=-1" for a in infer))
        budget = n_devices
        for axis in ("tp", "sp", "pp", "fsdp", "dp"):
            s = sizes[axis]
            if s == -1:
                continue
            s = max(1, min(s, budget))
            while budget % s:
                s -= 1
            sizes[axis] = s
            budget //= s
        if infer:
            sizes[infer[0]] = budget
        elif budget > 1:
            sizes["dp"] *= budget
        return MeshConfig(**sizes)


# Named mesh presets.  Fixed axes (tp=2) are degraded by ``clamp_to`` on
# smaller hardware, so every preset forms a valid mesh on any count.
MESH_PRESETS: Dict[str, MeshConfig] = {
    # pure data parallelism: params replicated, batch sharded
    "dp": MeshConfig(dp=-1),
    # ZeRO-style sharded data parallelism: params/opt-state sharded over
    # every card, gathered for compute
    "fsdp": MeshConfig(dp=1, fsdp=-1),
    # FSDP over the outer axis + Megatron tensor parallelism on 2
    # neighbouring cards
    "fsdp_tp": MeshConfig(dp=1, fsdp=-1, tp=2),
}


def resolve_mesh_config(
        mesh: Union[str, MeshConfig, None]) -> Optional[MeshConfig]:
    """Normalize a mesh request: a preset name from :data:`MESH_PRESETS`,
    a :class:`MeshConfig`, or None (caller's default)."""
    if mesh is None or isinstance(mesh, MeshConfig):
        return mesh
    if isinstance(mesh, str):
        try:
            return MESH_PRESETS[mesh]
        except KeyError:
            raise ValueError(
                f"unknown mesh preset {mesh!r}; valid presets: "
                f"{sorted(MESH_PRESETS)} (or pass a MeshConfig)") from None
    raise TypeError(
        f"mesh must be a preset name, MeshConfig, or None; got "
        f"{type(mesh).__name__}")


def mesh_shape_for(n_devices: int, config: Optional[MeshConfig] = None):
    return (config or MeshConfig()).resolve(n_devices)


@functools.lru_cache(maxsize=16)
def compute_mesh(mesh: Optional[DeviceMesh]) -> Optional[DeviceMesh]:
    """The mesh the port's DTensors live on: ``mesh`` sliced to its axes
    of size > 1 (a world of one keeps its first axis), reusing its
    process groups.  A size-1 axis shards nothing, and DTensor's sharding
    propagation enumerates strategies over every mesh dim, a product
    that grows with their number: on the five-axis mesh its first
    dispatch of one pointwise op took minutes.  Idempotent; None stays
    None; anything else raises ``TypeError``."""
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (parallel.create_mesh), "
                        f"got {type(mesh).__name__}")
    names = tuple(n for n, size in zip(mesh.mesh_dim_names, mesh.shape)
                  if size > 1) or mesh.mesh_dim_names[:1]
    return mesh if names == tuple(mesh.mesh_dim_names) else mesh[names]


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of mesh axis ``axis`` (1 when the mesh has none)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def _device_type(device) -> str:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch: CUDA is not available; pass device='cpu' to "
            "form a gloo mesh on the host")
    return dev.type


def ensure_process_group(device=None) -> None:
    """Join the default process group if this process has none: from the
    launcher's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, and ``LOCAL_RANK`` for the card), or, with none of it
    set, as a world of one.  NCCL on CUDA, gloo on the CPU."""
    dev_type = _device_type(device)
    if dev_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return
    backend = "nccl" if dev_type == "cuda" else "gloo"
    present = [k for k in _DIST_ENV if k in os.environ]
    if not present:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    if len(present) != len(_DIST_ENV):
        raise RuntimeError(
            f"partial distributed environment: {present} set, "
            f"{sorted(set(_DIST_ENV) - set(present))} missing")
    dist.init_process_group(backend, init_method="env://")


def create_mesh(config: Optional[MeshConfig] = None, *, device=None,
                axis_names: Tuple[str, ...] = MESH_AXES) -> DeviceMesh:
    """A mesh over every rank of the default process group (joined first
    if needed, ``ensure_process_group``), shaped by ``config`` (default
    ``MeshConfig()``: all ranks on ``dp``), one name per axis of
    ``MESH_AXES``.  ``device`` None means the GPU (NCCL); ``"cpu"`` forms
    a gloo mesh on the host."""
    ensure_process_group(device)
    return init_device_mesh(_device_type(device),
                            mesh_shape_for(dist.get_world_size(), config),
                            mesh_dim_names=tuple(axis_names))


def create_hybrid_mesh(*, ici_config: Optional[MeshConfig] = None,
                       num_slices: int = 1, device=None) -> DeviceMesh:
    """Mesh spanning ``num_slices`` nodes: ``dp`` over the nodes, the
    other axes over one node's cards (ranks node-major, as a launcher
    numbers them), so only dp gradient reductions cross nodes."""
    ensure_process_group(device)
    n = dist.get_world_size()
    if n % num_slices != 0:
        raise ValueError(f"{n} devices not divisible into {num_slices} slices")
    cfg = ici_config or MeshConfig(dp=1, fsdp=-1)
    ici_shape = cfg.resolve(n // num_slices)
    if cfg.dp != 1 and num_slices > 1:
        raise ValueError("dp must be 1 in ici_config for hybrid meshes")
    return init_device_mesh(_device_type(device),
                            (num_slices * ici_shape[0],) + ici_shape[1:],
                            mesh_dim_names=MESH_AXES)


def local_mesh(n: int = 1, *, device=None) -> DeviceMesh:
    """A ``dp`` mesh over this process's world, which must hold ``n``
    ranks (single-host dev/test; a world of one by default)."""
    ensure_process_group(device)
    if dist.get_world_size() != n:
        raise ValueError(f"local_mesh({n}) in a world of "
                         f"{dist.get_world_size()} ranks")
    return create_mesh(MeshConfig(dp=-1), device=device)
