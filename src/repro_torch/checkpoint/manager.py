"""Mesh-agnostic checkpointing with atomic commits and async save
(counterpart of ``repro.checkpoint.manager``).

Layout (one directory per step), the JAX package's byte for byte:

  <dir>/step_00000123/
    manifest.json          leaf count, dtypes, crc32, byte counts, metadata
    a_00000.npy ...        one file per leaf (the full logical array)

* A state tree is a tree of dicts and lists whose leaves are tensors;
  its leaves are taken in ``common.tree_leaves`` order (dict keys sorted,
  as ``jax.tree`` orders them) and a ``None`` leaf is an empty subtree, as
  in JAX: AdamW's ``master`` holds None for its f32 leaves, and they come
  back as None. bf16 and fp8 leaves, which npy cannot hold, are stored as
  a same-width unsigned view (``_VIEW_DTYPES``) and the manifest records
  their logical numpy / ml_dtypes names ("bfloat16", "float8_e4m3fn"),
  so the two packages' checkpoints of the same tree are the same bytes
  and each restores the other's.
* Checkpoints hold LOGICAL arrays, never a device layout: on a mesh
  (``MeshPlacement``) every leaf is gathered (``sharding.unshard``) and
  the mesh's first rank writes; on restore every rank reads the logical
  arrays and keeps its block (``sharding.shard``), on whatever mesh the
  job now runs: that is what an elastic shrink restores through.
* Atomic commit: write into ``step_N.tmp``, fsync every file, rename,
  fsync the directory. A crash never leaves a half checkpoint as latest.
* ``AsyncSaver`` snapshots the state into host memory synchronously (a
  real copy: AdamW updates the state in place, and ``t.cpu()`` of a CPU
  tensor would alias it) and writes in a background thread.
* ``restore`` fills the tensors of ``like`` in place (``copy_``) instead of
  allocating a second state: at full width one state may not fit on the
  card twice.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.common import tree_leaves, tree_map
from repro_torch.runtime import faults as faults_lib


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (missing/short/flipped
    leaf bytes, or no readable manifest). Raised by :func:`verify` and
    :func:`restore`; ``runtime.ft`` treats it as "fall back to the next
    older valid checkpoint", not as a training failure."""


#: Logical dtypes npy cannot hold -> the unsigned view stored on disk.
_VIEW_DTYPES = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
                "float8_e5m2": np.uint8}
#: The torch dtypes behind them, and the torch view of the same width.
_TORCH_VIEWS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
                torch.float8_e5m2: torch.uint8}


def dtype_name(dtype) -> str:
    """The numpy / ml_dtypes name of a torch or numpy dtype ("float32",
    "bfloat16", "float8_e4m3fn"): what the manifest records."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def _flatten(tree: Any) -> list:
    """The tree's leaves in ``tree_leaves`` order, ``None`` left out."""
    return [leaf for leaf in tree_leaves(tree) if leaf is not None]


def _treedef(tree: Any) -> str:
    """A printable structure of ``tree``: leaves as '*', None as 'None'."""
    return repr(tree_map(lambda leaf: None if leaf is None else "*", tree))


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(the array written to disk, its logical dtype name) of one leaf: a
    copy in host memory that shares no storage with ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = dtype_name(t.dtype)
        view = _TORCH_VIEWS.get(t.dtype)
        if view is not None:
            return t.view(view).numpy().view(_VIEW_DTYPES[name]), name
        return t.numpy(), name
    arr = np.array(leaf)
    name = str(arr.dtype)
    view = _VIEW_DTYPES.get(name)
    return (arr.view(view) if view is not None else arr), name


def _from_host(h: np.ndarray, i: int, target: torch.dtype) -> torch.Tensor:
    """Leaf ``i`` as loaded (``h``) as a CPU tensor of ``target``; a
    stored dtype other than the target's raises (no silent cast)."""
    if not h.flags.c_contiguous:
        h = np.ascontiguousarray(h)
    view = _TORCH_VIEWS.get(target)
    if view is not None:
        want = np.dtype(_VIEW_DTYPES[dtype_name(target)])
        if h.dtype != want:
            raise ValueError(
                f"leaf {i}: stored dtype {h.dtype} does not match target "
                f"{dtype_name(target)} (refusing a silent cast)")
        signed = np.int16 if view == torch.int16 else np.uint8
        return torch.from_numpy(h.view(signed)).view(
            target)
    t = torch.from_numpy(h)
    if t.dtype != target:
        raise ValueError(
            f"leaf {i}: stored dtype {h.dtype} does not match target "
            f"{dtype_name(target)} (refusing a silent cast)")
    return t


#: Threads that write, read and check leaf files at once (zlib's crc32 and
#: the file calls release the GIL).
IO_THREADS = 8


def _npy_bytes(arr: np.ndarray) -> tuple:
    """(header, data) of ``arr`` as ``np.save`` writes them: the version
    1.0 header np.save picks for these dtypes, then the C-order bytes, as
    a view where the array is contiguous (no copy)."""
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        head, np.lib.format.header_data_from_array_1_0(arr))
    flat = np.ascontiguousarray(arr).reshape(-1)
    return head.getvalue(), memoryview(flat).cast("B")


def _write_leaf(path: str, arr: np.ndarray) -> tuple:
    """Write one leaf file, flushed to stable storage before the commit
    rename; (crc32, byte count) of the exact bytes written, npy header
    included, with no second read pass."""
    head, data = _npy_bytes(arr)
    with open(path, "wb") as f:
        f.write(head)
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return zlib.crc32(data, zlib.crc32(head)), len(head) + len(data)


def _fsync_write(path: str, write_fn) -> None:
    """Write + flush one file to stable storage before the commit rename."""
    with open(path, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _write(directory: str, step: int, host: List[Tuple[np.ndarray, str]],
           treedef: str, meta: dict) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    with ThreadPoolExecutor(IO_THREADS) as pool:
        done = list(pool.map(
            _write_leaf, [os.path.join(tmp, f"a_{i:05d}.npy")
                          for i in range(len(host))], [a for a, _ in host]))
    crcs = [c for c, _ in done]
    nbytes = [n for _, n in done]
    manifest = {
        "step": step,
        "treedef": treedef,
        "num_leaves": len(host),
        # LOGICAL dtypes (before the view): restore checks them against
        # the target's leaves before any array is loaded
        "dtypes": [name for _, name in host],
        # per-leaf integrity record over the exact file bytes: verify and
        # restore recompute it, so a truncated or flipped leaf is caught
        # before it reaches the model
        "crc32": crcs,
        "nbytes": nbytes,
        "meta": meta,
        "process_index": _process_index(),
    }
    _fsync_write(os.path.join(tmp, "manifest.json"),
                 lambda f: f.write(json.dumps(manifest, indent=1).encode()))
    if os.path.exists(final):
        shutil.rmtree(final)
    # the rename is the commit point: the data was fsynced above and the
    # directory entry is fsynced after, so "latest" is always complete
    os.replace(tmp, final)
    dir_fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)
    # chaos hook (DESIGN.md §9): "ckpt.write" faults damage a committed
    # leaf file in place, after the commit
    for f in faults_lib.inject("ckpt.write", step=step, path=final):
        if f.kind in ("truncate", "bitflip"):
            faults_lib.corrupt_checkpoint(final, f)
    return final


class MeshPlacement:
    """Where the leaves of a state tree lie on a mesh: ``specs`` and
    ``shapes`` are trees of ``like``'s structure holding each leaf's
    logical spec (``models.lm.param_specs``'s) and global shape, placed
    under ``pcfg`` on ``mesh`` as ``parallel.sharding.shard`` places them
    (the placement ``convert.shard_params`` and ``shard_opt_state`` cut
    by). It is the ``shardings`` of ``save``, ``AsyncSaver.save`` and
    ``restore``: saving gathers the logical leaves and the mesh's first
    rank writes them; restoring keeps this rank's block of each."""

    def __init__(self, like: Any, specs: Any, shapes: Any, pcfg, mesh):
        self.pcfg = pcfg
        self.mesh = mesh
        pairs = tree_map(lambda leaf, sp, sh: None if leaf is None
                         else (tuple(sp), tuple(sh)), like, specs, shapes)
        self.leaves = [p for p in tree_leaves(pairs) if p is not None]

    @property
    def writer(self) -> bool:
        """Whether this rank writes the checkpoint: the mesh's first."""
        return self.mesh.is_first()

    def snapshot(self, tree: Any) -> Optional[List[Tuple[np.ndarray, str]]]:
        """The logical leaves of this rank's shards ``tree`` in host memory
        on the writer, None elsewhere; leaf by leaf, so one gathered leaf
        at a time is on the device (collective: every rank calls it)."""
        from repro_torch.parallel.sharding import unshard

        leaves = _flatten(tree)
        if len(leaves) != len(self.leaves):
            raise ValueError(f"tree has {len(leaves)} leaves, the placement "
                             f"{len(self.leaves)}")
        host = [] if self.writer else None
        for t, (spec, shape) in zip(leaves, self.leaves):
            full = unshard(t, spec, self.pcfg, self.mesh, shape)
            if host is not None:
                host.append(_to_host(full))
            del full
        return host

    def template(self, like: Any, device) -> Any:
        """Empty tensors of this rank's block shapes in ``like``'s
        structure and dtypes (None where ``like`` has None): what a
        restore onto this placement fills."""
        from repro_torch.parallel.sharding import as_axes, physical_spec

        it = iter(self.leaves)

        def one(leaf):
            if leaf is None:
                return None
            spec, shape = next(it)
            phys = physical_spec(shape, spec, self.pcfg, self.mesh)
            entries = list(phys) + [None] * (len(shape) - len(phys))
            block = [d // self.mesh.size(as_axes(e))
                     for d, e in zip(shape, entries)]
            return torch.empty(block, dtype=leaf.dtype, device=device)

        return tree_map(one, like)

    def block(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of logical leaf ``i``."""
        from repro_torch.parallel.sharding import shard

        return shard(full, self.leaves[i][0], self.pcfg, self.mesh)

    def barrier(self) -> None:
        """Every rank of the mesh waits for all of them."""
        self.mesh.barrier()


def _snapshot(tree: Any, shardings: Optional[MeshPlacement]):
    if shardings is None:
        return [_to_host(leaf) for leaf in _flatten(tree)]
    return shardings.snapshot(tree)


def save(directory: str, step: int, tree: Any, meta: Optional[dict] = None,
         shardings: Optional[MeshPlacement] = None) -> Optional[str]:
    """Synchronous atomic checkpoint save. Returns the final path (None on
    a rank of a mesh that does not write; every rank returns once the
    checkpoint is committed)."""
    host = _snapshot(tree, shardings)
    path = None
    if host is not None:
        path = _write(directory, step, host, _treedef(tree), meta or {})
    if shardings is not None:
        shardings.barrier()
    return path


class AsyncSaver:
    """Snapshot-to-host synchronously, write in a background thread.

    A failed background write re-raises at the next ``wait()`` (or the next
    ``save()``, which waits first) instead of vanishing with the thread —
    otherwise the trainer keeps running, ``gc_old`` prunes the older good
    checkpoints, and a later warm restart restores something stale while
    believing the newest save succeeded."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, directory: str, step: int, tree: Any,
             meta: Optional[dict] = None,
             post: Optional[Callable[[str], None]] = None,
             shardings: Optional[MeshPlacement] = None) -> None:
        """Queue an async write. ``post(final_path)`` runs in the worker
        thread only after the write commits — the ordering hook retention
        GC needs: pruning against a listing that already contains the new
        checkpoint, never racing the in-flight write. On a mesh every rank
        takes part in the snapshot and waits at a barrier after it; the
        writer alone starts a thread."""
        self.wait()
        host = _snapshot(tree, shardings)
        if shardings is not None:
            shardings.barrier()
        if host is None:
            return
        treedef = _treedef(tree)

        def work():
            try:
                t0 = obs.tracer.clock()
                self.last_path = _write(directory, step, host, treedef,
                                        meta or {})
                obs.tracer.complete("ckpt.write", t0, obs.tracer.clock(),
                                    step=step)
                if post is not None:
                    post(self.last_path)
            except BaseException as exc:  # noqa: BLE001 — handed to wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight write; re-raise its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc


def _committed_steps(directory: str) -> list:
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")]


def committed_steps(directory: str) -> list:
    """Committed steps on disk, newest first, integrity-unchecked."""
    if not os.path.isdir(directory):
        return []
    return sorted(_committed_steps(directory), reverse=True)


def latest_step(directory: str) -> Optional[int]:
    """Newest COMMITTED step on disk, integrity-unchecked — "what
    exists", not "what is safe to load" (that is
    :func:`latest_valid_step`)."""
    if not os.path.isdir(directory):
        return None
    steps = _committed_steps(directory)
    return max(steps) if steps else None


def _manifest(path: str) -> dict:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)
    except (OSError, ValueError) as exc:
        raise CheckpointCorruptError(
            f"{path}: unreadable manifest ({exc})") from exc


def _read_leaf(path: str, i: int, manifest: dict) -> np.ndarray:
    """Leaf ``i``'s file bytes (a uint8 array), checked against the
    manifest's byte count and crc32 (where it records them)."""
    try:
        with open(os.path.join(path, f"a_{i:05d}.npy"), "rb") as f:
            data = np.empty(os.fstat(f.fileno()).st_size, np.uint8)
            data = data[:f.readinto(data)]
    except OSError as exc:
        raise CheckpointCorruptError(
            f"{path}: missing leaf {i} ({exc})") from exc
    nbytes, crcs = manifest.get("nbytes"), manifest.get("crc32")
    if nbytes is not None and len(data) != nbytes[i]:
        raise CheckpointCorruptError(
            f"{path}: leaf {i} has {len(data)} bytes, "
            f"manifest records {nbytes[i]} (truncated/partial write)")
    if crcs is not None and zlib.crc32(data) != crcs[i]:
        raise CheckpointCorruptError(
            f"{path}: leaf {i} crc32 mismatch (corrupt bytes)")
    return data


def _parse_npy(data: np.ndarray) -> np.ndarray:
    """The array an npy file's bytes (a uint8 array) hold, as a view of
    ``data``."""
    head = io.BytesIO(data[:1 << 17].tobytes())
    version = np.lib.format.read_magic(head)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(head)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(head)
    else:
        raise ValueError(f"npy version {version} is not read here")
    count = 1
    for d in shape:
        count *= d
    arr = np.frombuffer(data, dtype=dtype, count=count, offset=head.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


def verify(path: str) -> None:
    """Integrity-check one committed checkpoint directory against its
    manifest: every leaf file must exist with exactly the recorded byte
    count and crc32. Raises :class:`CheckpointCorruptError` on any
    mismatch; checkpoints without a ``crc32`` record pass, so old
    on-disk trees stay restorable. The leaves are read ``IO_THREADS`` at
    a time; the lowest failing leaf's error is raised."""
    manifest = _manifest(path)

    def check(i):                 # the bytes are dropped as soon as read
        _read_leaf(path, i, manifest)

    with ThreadPoolExecutor(IO_THREADS) as pool:
        for _ in pool.map(check, range(manifest["num_leaves"])):
            pass                  # raises the lowest failing leaf's error


def valid_steps(directory: str) -> list:
    """Committed steps that pass :func:`verify`, newest first — the
    fallback-restore walk order of ``runtime.ft.run_with_recovery``."""
    good = []
    for s in committed_steps(directory):
        try:
            verify(os.path.join(directory, f"step_{s:08d}"))
        except CheckpointCorruptError:
            continue
        good.append(s)
    return good


def latest_valid_step(directory: str) -> Optional[int]:
    """Newest committed step that passes integrity verification, skipping
    corrupt/partial checkpoints (None when no checkpoint loads)."""
    good = valid_steps(directory)
    return good[0] if good else None


@torch.no_grad()
def restore(directory: str, step: int, like: Any,
            shardings: Optional[MeshPlacement] = None) -> tuple:
    """Restore checkpoint ``step`` INTO the tensors of ``like`` (in place,
    ``copy_``) and return ``(like, meta)``. With ``shardings`` (a
    ``MeshPlacement``) each leaf of ``like`` is this rank's block and
    receives its block of the stored logical array: the elastic re-shard.
    The leaf count, each leaf's dtype and each block's shape must match;
    nothing is cast. Every leaf is read once (``IO_THREADS`` at a time)
    and verified before any is copied in, so the checkpoint's bytes are
    held in host memory while it restores."""
    path = os.path.join(directory, f"step_{step:08d}")
    manifest = _manifest(path)
    # every leaf read once and checked (crc32 + byte count) before any is
    # copied in: damaged bytes never reach the state
    with ThreadPoolExecutor(IO_THREADS) as pool:
        futures = [pool.submit(_read_leaf, path, i, manifest)
                   for i in range(manifest["num_leaves"])]
        files = [fut.result() for fut in futures]
    leaves = _flatten(like)
    assert manifest["num_leaves"] == len(leaves), (
        f"checkpoint has {manifest['num_leaves']} leaves, "
        f"target structure has {len(leaves)}")
    stored = manifest.get("dtypes")
    if stored is not None:
        mismatched = [
            f"leaf {i}: checkpoint {s} vs target {dtype_name(t.dtype)}"
            for i, (s, t) in enumerate(zip(stored, leaves))
            if s != dtype_name(t.dtype)]
        if mismatched:
            raise ValueError("checkpoint/target dtype mismatch:\n  "
                             + "\n  ".join(mismatched))
    for i, t in enumerate(leaves):
        src = _from_host(_parse_npy(files[i]), i, t.dtype)
        files[i] = None
        if shardings is not None:
            src = shardings.block(i, src)
        assert tuple(src.shape) == tuple(t.shape), (i, src.shape, t.shape)
        t.copy_(src)
    return like, manifest["meta"]


def gc_old(directory: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed checkpoints.

    ``keep=0`` deletes everything. ``.tmp`` dirs are never touched: one
    may belong to an in-flight ``AsyncSaver`` write, and ``_write`` clears
    its own stale tmp before re-using the name."""
    if keep < 0:
        raise ValueError(f"keep must be >= 0, got {keep}")
    if not os.path.isdir(directory):
        return
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:max(len(steps) - keep, 0)]:
        shutil.rmtree(os.path.join(directory, d))
