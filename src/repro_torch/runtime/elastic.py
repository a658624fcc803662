"""Elastic scaling: choose a mesh for whatever ranks survive (counterpart
of ``repro.runtime.elastic``).

Checkpoints are mesh-agnostic (logical arrays), so elasticity reduces to:
(1) pick a new (data, model) factorisation for the surviving rank count,
(2) place the restored logical arrays on it (``checkpoint.manager``'s
``MeshPlacement``). ``choose_mesh_shape`` prefers keeping the model axis
at the architecture's minimum TP degree (enough memory per shard) and
gives the rest to data parallelism; the batch is re-split by the
heterogeneous planner if the surviving pool is uneven.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union


def choose_mesh_shape(
    num_devices: int,
    *,
    min_model: int = 1,
    max_model: Optional[int] = None,
    param_bytes: Optional[int] = None,
    hbm_bytes: int = 16 * 2**30,
) -> tuple[int, int]:
    """Largest (data, model) grid with model >= minimum TP for memory.

    If ``param_bytes`` is given, min_model is raised until params (+2x for
    optimizer) fit per device under pure TP+FSDP sharding heuristics.
    """
    if param_bytes is not None:
        # model axis must be wide enough that one TP-sharded copy of the
        # (bf16) parameters occupies at most half a device's memory — the
        # residency a decode/serving replica needs.
        while (
            min_model < num_devices
            and param_bytes / min_model > hbm_bytes * 0.5
        ):
            min_model *= 2
    model = min_model
    max_model = max_model or num_devices
    while num_devices % model != 0 and model <= max_model:
        model += 1
    model = min(model, max_model, num_devices)
    data = num_devices // model
    return data, model


def survivor_ranks(survivors: Union[int, Sequence[int]]) -> list:
    """The ranks a dropout leaves: an int N means the first N ranks, a
    sequence names them."""
    if isinstance(survivors, int):
        return list(range(survivors))
    return [int(r) for r in survivors]


def make_mesh(shape: Sequence[int], names: Sequence[str],
              ranks: Optional[Sequence[int]] = None, *,
              device_type: Optional[str] = None):
    """A ``launch.mesh.Mesh`` of ``shape`` over the first ``prod(shape)``
    of ``ranks`` (default: the job's ranks in order): the surviving-pool
    re-mesh. Collective over the whole job: every rank, those left out
    included, takes part in creating the mesh's groups; a rank left out
    holds none (``Mesh.member()`` is False) and must call no collective
    on the mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh

    n = 1
    for s in shape:
        n *= int(s)
    ranks = (list(range(dist.get_world_size())) if ranks is None
             else [int(r) for r in ranks])
    if len(ranks) < n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; "
                         f"{len(ranks)} survive")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(None, names, shape, ranks=ranks[:n], device_type=device_type)
