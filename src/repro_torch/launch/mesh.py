"""Named process meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A ``Mesh`` lays the job's ranks out row-major over named axes (``init_device_mesh``)
and keeps one process group for every subset of them, so a collective can
run over any tuple of axes: a tuple is major first, in mesh order, which
is the order JAX concatenates a gather over several axes in. A two-level
mesh, ("data", "node", "model") or ("pod", "data", "node", "model")
(``split_model_axis``), is laid out the same way: the ("node", "model")
group is node-major, as ``Mesh.index`` counts it, so a gather phased
over "model" and then "node" concatenates as the flat one does. Its
collectives (``all_gather``, ``reduce_scatter``, ``all_reduce``,
``all_to_all``, ``broadcast0``) take and return plain tensors without
autograd; the MoE islands wrap them in autograd Functions
(``parallel.moe_parallel``).
They run even over a group of one rank (the card's 1-rank mesh), where
an all-gather still writes a fresh tensor.

``launch_local`` starts N ranks on the CPU with the gloo backend, each in
a process of its own, for tests: the port's counterpart of faking
devices with ``XLA_FLAGS``. ``single_rank_nccl`` opens a 1-rank NCCL
group on one card in this process. Both rendezvous through a
``FileStore`` in a temporary directory, never a TCP port, so concurrent
launches cannot collide. ``cli_process_group`` gives a CLI's ``--mesh``
its group: the caller's (``launch_local``), ``torchrun``'s, or one of a
single rank.
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
    tuple of axes (in mesh order). ``ranks`` (row-major over ``shape``)
    are the global ranks the mesh holds: the whole job by default, or
    the survivors of an elastic shrink (``runtime.elastic.make_mesh``),
    whose groups every rank of the job takes part in creating; a rank
    outside ``ranks`` holds no group and calls no collective on it."""

    def __init__(self, device_mesh, axis_names: Sequence[str],
                 shape: Sequence[int], *, ranks: Optional[Sequence[int]] = None,
                 device_type: Optional[str] = None):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        dims = list(self.shape.values())
        self.ranks = (list(range(dist.get_world_size())) if ranks is None
                      else [int(r) for r in ranks])
        if len(self.ranks) != self.size(self.axis_names):
            raise ValueError(f"mesh {tuple(dims)} needs "
                             f"{self.size(self.axis_names)} ranks, got "
                             f"{len(self.ranks)}")
        self.device_type = (device_mesh.device_type if device_mesh is not None
                            else device_type)
        rank = dist.get_rank()
        grid = torch.tensor(self.ranks).reshape(dims)
        hit = (grid == rank).nonzero().tolist()
        self._coords = (dict(zip(self.axis_names, hit[0])) if hit else None)
        self._groups = {}
        # every rank creates every group, in the same order (new_group is
        # collective over the world)
        for r in range(1, len(dims) + 1):
            for sub in itertools.combinations(range(len(dims)), r):
                axes = tuple(self.axis_names[i] for i in sub)
                if r == 1 and device_mesh is not None:
                    self._groups[axes] = device_mesh.get_group(axes[0])
                    continue
                rest = [i for i in range(len(dims)) if i not in sub]
                moved = grid.permute(*rest, *sub).reshape(-1, self.size(axes))
                for members in moved.tolist():
                    g = dist.new_group(members)
                    if rank in members:
                        self._groups[axes] = g

    def member(self) -> bool:
        """Whether this rank is on the mesh."""
        return self._coords is not None

    def is_first(self) -> bool:
        """Whether this rank is the mesh's first (its writer and printer)."""
        return dist.get_rank() == self.ranks[0]

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

    def broadcast0(self, x: torch.Tensor) -> torch.Tensor:
        """The mesh's first rank's ``x`` on every rank of the mesh (in
        place; ``x`` is returned)."""
        if len(self.ranks) > 1:
            dist.broadcast(x, src=self.ranks[0],
                           group=self.group(self.axis_names))
        return x

    def barrier(self) -> None:
        """Every rank of the mesh waits for all of them: a one-element
        all-reduce read back on the host (NCCL's barrier would need the
        device of each rank)."""
        dev = "cuda" if self.device_type == "cuda" else "cpu"
        self.all_reduce(torch.zeros(1, device=dev), self.axis_names).item()

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


@contextlib.contextmanager
def cli_process_group(device: torch.device, world: int):
    """The process group of a CLI run on a mesh of ``world`` ranks, for
    the length of the block; yields the device this rank runs on.

    An initialised group (``launch_local``'s ranks, or a caller's) is
    used as it is. Under ``torchrun`` (``RANK``/``WORLD_SIZE`` in the
    environment) the group is made from its environment: NCCL with this
    rank on ``cuda:LOCAL_RANK``, or gloo where ``device`` is the CPU. A
    process on its own makes a group of one rank (``single_rank_nccl`` on
    the card, gloo on the CPU) when the mesh has one rank. Anything else
    raises, naming ``torchrun``. A group made here is destroyed on exit."""
    if dist.is_initialized():
        _check_world(world)
        yield device
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
        try:
            _check_world(world)
            yield device
        finally:
            dist.destroy_process_group()
        return
    if world != 1:
        raise RuntimeError(
            f"a mesh of {world} ranks needs as many processes: start the "
            f"CLI under torchrun --nproc-per-node {world} (or "
            f"launch.mesh.launch_local)")
    if device.type == "cuda":
        with single_rank_nccl(device.index or 0):
            yield device
        return
    with tempfile.TemporaryDirectory(prefix="repro_gloo_") as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            yield device
        finally:
            dist.destroy_process_group()


def _check_world(world: int) -> None:
    if dist.get_world_size() != world:
        raise ValueError(f"the mesh needs {world} ranks; the job has "
                         f"{dist.get_world_size()}")


def is_rank0() -> bool:
    """Whether this process prints for the job: rank 0, or no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def parse_mesh(text: str, topology=None):
    """A CLI's ``--mesh`` ("2,4"): (dims, axes), the axes the last
    ``len(dims)`` of ("pod", "data", "model"), as the JAX CLIs name
    them; with a ``topology`` (``autotune.Topology``) the model extent
    split into ("node", "model") by ``split_model_axis``."""
    dims = tuple(int(x) for x in text.split(","))
    if not 1 <= len(dims) <= 3 or any(d < 1 for d in dims):
        raise ValueError(f"--mesh {text!r}: one to three positive sizes")
    axes = ("pod", "data", "model")[-len(dims):]
    if topology is not None:
        dims, axes = split_model_axis(dims, axes, topology.node_size)
    return dims, axes


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
