"""Named process meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A ``Mesh`` lays the job's ranks out row-major over named axes (``init_device_mesh``)
and keeps one process group for every subset of them, so a collective can
run over any tuple of axes: a tuple is major first, in mesh order, which
is the order JAX concatenates a gather over several axes in. Its
collectives (``all_gather``, ``reduce_scatter``, ``all_reduce``,
``all_to_all``) take and return plain tensors without autograd; the MoE
islands wrap them in autograd Functions (``parallel.moe_parallel``).
They run even over a group of one rank (the card's 1-rank mesh), where
an all-gather still writes a fresh tensor.

``launch_local`` starts N ranks on the CPU with the gloo backend, each in
a process of its own, for tests: the port's counterpart of faking
devices with ``XLA_FLAGS``. ``single_rank_nccl`` opens a 1-rank NCCL
group on one card in this process. Both rendezvous through a
``FileStore`` in a temporary directory, never a TCP port, so concurrent
launches cannot collide.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import traceback
import warnings
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import as_axes


class Mesh:
    """The ranks of the job on named axes, with a process group for each
    tuple of axes (in mesh order)."""

    def __init__(self, device_mesh, axis_names: Sequence[str],
                 shape: Sequence[int]):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device_type = device_mesh.device_type
        self._coords = dict(zip(self.axis_names,
                                device_mesh.get_coordinate()))
        self._groups = {}
        rank = dist.get_rank()
        dims = list(self.shape.values())
        grid = torch.arange(dist.get_world_size()).reshape(dims)
        # every rank creates every group, in the same order (new_group is
        # collective over the world)
        for r in range(1, len(dims) + 1):
            for sub in itertools.combinations(range(len(dims)), r):
                axes = tuple(self.axis_names[i] for i in sub)
                if r == 1:
                    self._groups[axes] = device_mesh.get_group(axes[0])
                    continue
                rest = [i for i in range(len(dims)) if i not in sub]
                moved = grid.permute(*rest, *sub).reshape(-1, self.size(axes))
                for ranks in moved.tolist():
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        self._groups[axes] = g

    def size(self, axes) -> int:
        """Ranks in a group of ``axes`` (a name or a tuple; 1 for ())."""
        n = 1
        for a in as_axes(axes):
            n *= self.shape[a]
        return n

    def coord(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self._coords[axis]

    def index(self, axes) -> int:
        """This rank's linear position in its group of ``axes``, major
        first: its block of a dimension sharded over them."""
        i = 0
        for a in as_axes(axes):
            i = i * self.shape[a] + self._coords[a]
        return i

    def group(self, axes):
        axes = as_axes(axes)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return self._groups[axes]

    # -- collectives (no autograd) ---------------------------------------

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Concatenate every group member's ``x`` along ``dim`` (tiled)."""
        axes = as_axes(axes)
        if not axes:
            return x
        n = self.size(axes)
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((n,) + tuple(src.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out.view((n * src.shape[0],)
                                             + tuple(src.shape[1:])),
                                    src, group=self.group(axes))
        out = out.movedim(1, dim + 1).movedim(0, dim)  # (.., n, d_l, ..)
        shape = list(x.shape)
        shape[dim] *= n
        return out.reshape(shape).contiguous()

    def reduce_scatter(self, x: torch.Tensor, axes,
                       dim: int = 0) -> torch.Tensor:
        """Sum over the group, each member keeping its block of ``dim``."""
        axes = as_axes(axes)
        if not axes:
            return x
        n = self.size(axes)
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=self.group(axes))
        return out.movedim(0, dim).contiguous()

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum over the group (a new tensor)."""
        axes = as_axes(axes)
        if not axes:
            return x
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group(axes))
        return out

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Block i of dim 0 goes to member i; block j of the result came
        from member j (JAX's ``all_to_all`` with split = concat = 0)."""
        axes = as_axes(axes)
        if not axes:
            return x
        src = x.contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group(axes))
        return out


def make_mesh(shape, axes, *, device_type: Optional[str] = None) -> Mesh:
    """A mesh of ``shape`` over named ``axes`` on the initialised default
    process group, whose world size must be the product of ``shape``.
    ``device_type`` defaults to "cuda" on NCCL, else "cpu"."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {shape} needs {n} ranks; the job has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return Mesh(dm, axes, shape)


def make_production_mesh(*, model: int = 1, pods: Optional[int] = None,
                         device_type: Optional[str] = None) -> Mesh:
    """The mesh over every rank of the job: ("data", "model") with
    ``model`` ranks a TP group, or ("pod", "data", "model") with ``pods``
    pods (Swin's islands need the "pod" axis)."""
    world = dist.get_world_size()
    lead = 1 if pods is None else pods
    if world % (lead * model):
        raise ValueError(f"{world} ranks do not split into {lead} pods of "
                         f"TP groups of {model}")
    data = world // (lead * model)
    if pods is None:
        return make_mesh((data, model), ("data", "model"),
                         device_type=device_type)
    return make_mesh((pods, data, model), ("pod", "data", "model"),
                     device_type=device_type)


def split_model_axis(shape, axes, node_size: int):
    """Split the "model" extent into ("node", "model") for a two-level
    interconnect: node-major, so the flattened rank order (and every
    gather's concatenation order) matches the flat mesh exactly. A TP
    group that fits inside one node, or whose extent ``node_size`` does
    not divide, is left flat."""
    shape, axes = tuple(shape), tuple(axes)
    if "model" not in axes or node_size < 1:
        return shape, axes
    i = axes.index("model")
    m = shape[i]
    if node_size >= m or m % node_size != 0:
        return shape, axes
    return (
        shape[:i] + (m // node_size, node_size) + shape[i + 1:],
        axes[:i] + ("node", "model") + axes[i + 1:],
    )


@contextlib.contextmanager
def single_rank_nccl(device: int = 0):
    """A 1-rank NCCL process group on ``cuda:device`` for the length of the
    block (a mesh of ones over it runs the mesh path on one card);
    destroyed on exit, failures included. No other backend takes over."""
    with tempfile.TemporaryDirectory(prefix="repro_nccl_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0,
                                device_id=torch.device("cuda", device))
        try:
            if dist.get_backend() != "nccl":
                raise RuntimeError(f"backend {dist.get_backend()}, not nccl")
            yield
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# local multi-rank launcher (CPU, gloo)
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world, store_path, args, queue):
    torch.set_num_threads(1)
    # torch 2.13 steers reduce_scatter_tensor and all_gather_into_tensor to
    # *_single names that the card's torch 2.11 lacks; the port keeps the
    # names both have
    warnings.filterwarnings("ignore", category=FutureWarning,
                            message=".*is deprecated. Please use")
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            world_size=world, rank=rank)
    try:
        queue.put((rank, True, fn(rank, *args)))
    except Exception:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def launch_local(fn: Callable, world: int, *args, timeout: float = 300.0):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks on the CPU, each a
    spawned process (so ``fn`` and ``args`` must pickle: a module-level
    function), and return their results in rank order. A rank that raises
    raises here with its traceback; every process is joined or killed
    before this returns."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, store, args, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, errors = {}, []
        try:
            while len(results) + len(errors) < world:
                try:
                    rank, ok, value = q.get(timeout=timeout)
                except queue_mod.Empty:
                    raise TimeoutError(
                        f"launch_local: {world - len(results)} of {world} "
                        f"ranks gave no result in {timeout}s") from None
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
        finally:
            for p in procs:
                p.join(timeout=10 if not errors else 1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("launch_local: " + "\n".join(errors))
    return [results[r] for r in range(world)]
