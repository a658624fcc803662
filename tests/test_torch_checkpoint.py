"""The port's checkpoint manager (``repro_torch.checkpoint.manager``)
against the JAX package's.

* ``tests/test_checkpoint.py``'s cases on torch trees: save -> restore
  round-trips (restore fills the target's tensors in place), the async
  saver's snapshot, failure propagation and ``post`` ordering, ``gc_old``,
  bf16 / fp8 views, the dtype guard, the crc32 record, ``verify``,
  ``latest_valid_step`` and the ``ckpt.write`` fault site;
* one mixed tree (f32, bf16, int8, fp8 e4m3, a 0-d int32 and a None
  leaf) drawn from one numpy seed, saved by both packages: the leaf files
  are byte-equal and the manifests equal, ``treedef`` and
  ``process_index`` aside; each package restores the other's directory
  bit for bit;
* the async snapshot is a copy: an in-place update after ``save`` does
  not reach the file.
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager
from repro_torch.common import tree_leaves, tree_map
from repro_torch.runtime import faults as faults_lib


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((4, 8), generator=g),
        "moments": {
            "bf16": torch.randn((3, 5), generator=g).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32),
        },
        "list": [torch.arange(6), torch.ones((2,))],
    }


def _zeros_like(tree):
    return tree_map(lambda t: None if t is None else torch.zeros_like(t),
                    tree)


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.element_size() == 1
                           else x, y.view(torch.uint8)
                           if y.element_size() == 1 else y)


def test_sync_roundtrip(tmp_path):
    tree = _tree()
    path = manager.save(str(tmp_path), 3, tree, meta={"tag": "x"})
    assert path.endswith("step_00000003")
    assert manager.latest_step(str(tmp_path)) == 3
    like = _zeros_like(tree)
    restored, meta = manager.restore(str(tmp_path), 3, like)
    assert meta == {"tag": "x"}
    assert restored is like          # filled in place
    _assert_trees_equal(tree, restored)


def test_async_save_wait_restore_roundtrip(tmp_path):
    saver = manager.AsyncSaver()
    tree = _tree(1)
    saver.save(str(tmp_path), 10, tree, meta={"k": 1})
    saver.wait()
    assert saver.last_path is not None and saver.last_path.endswith(
        "step_00000010")
    tree2 = _tree(2)
    saver.save(str(tmp_path), 11, tree2)
    saver.wait()
    assert manager.latest_step(str(tmp_path)) == 11
    restored, _ = manager.restore(str(tmp_path), 11, _zeros_like(tree2))
    _assert_trees_equal(tree2, restored)
    restored10, meta10 = manager.restore(str(tmp_path), 10,
                                         _zeros_like(tree))
    assert meta10 == {"k": 1}
    _assert_trees_equal(tree, restored10)


def test_async_snapshot_is_a_copy(tmp_path):
    """AdamW updates the state in place: the saver's snapshot must not
    alias the live tensors, on the CPU too (``t.cpu()`` would)."""
    tree = _tree(3)
    want = tree_map(lambda t: t.clone(), tree)
    saver = manager.AsyncSaver()
    saver.save(str(tmp_path), 1, tree)
    for t in tree_leaves(tree):
        t.add_(1)                       # the next step, in place
    saver.wait()
    restored, _ = manager.restore(str(tmp_path), 1, _zeros_like(tree))
    _assert_trees_equal(want, restored)


def test_async_failure_propagates_on_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("occupied")
    saver = manager.AsyncSaver()
    saver.save(str(blocker), 1, _tree())
    with pytest.raises(OSError):
        saver.wait()
    saver.save(str(tmp_path), 2, _tree())
    saver.wait()
    assert manager.latest_step(str(tmp_path)) == 2


def test_latest_step_ignores_tmp(tmp_path):
    manager.save(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000099.tmp")
    assert manager.latest_step(str(tmp_path)) == 1


def test_gc_old_keep_boundary(tmp_path):
    tree = {"x": torch.arange(3)}
    for step in (1, 2, 5, 9):
        manager.save(str(tmp_path), step, tree)
    manager.gc_old(str(tmp_path), keep=2)
    left = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert left == ["step_00000005", "step_00000009"]
    manager.gc_old(str(tmp_path), keep=10)
    assert len(os.listdir(tmp_path)) == 2
    manager.gc_old(str(tmp_path), keep=0)
    assert [d for d in os.listdir(tmp_path) if d.startswith("step_")] == []
    with pytest.raises(ValueError):
        manager.gc_old(str(tmp_path), keep=-1)


def test_gc_old_never_touches_tmp(tmp_path):
    manager.save(str(tmp_path), 1, _tree())
    manager.save(str(tmp_path), 2, _tree())
    os.makedirs(tmp_path / "step_00000000.tmp")
    manager.gc_old(str(tmp_path), keep=1)
    assert sorted(os.listdir(tmp_path)) == ["step_00000000.tmp",
                                            "step_00000002"]


def test_restore_applies_dtype_views(tmp_path):
    tree = {"b": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)}
    manager.save(str(tmp_path), 1, tree)
    on_disk = np.load(tmp_path / "step_00000001" / "a_00000.npy")
    assert on_disk.dtype == np.uint16
    restored, _ = manager.restore(str(tmp_path), 1, _zeros_like(tree))
    _assert_trees_equal(tree, restored)


def test_mixed_dtype_tree_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    tree = {
        "ffn": {
            "w_gate": torch.from_numpy(
                rng.integers(-127, 128, size=(2, 4, 8)).astype(np.int8)),
            "w_gate_scale": torch.from_numpy(
                rng.random((2, 1, 1)).astype(np.float32)),
            "w_up": torch.from_numpy(
                rng.random((2, 4, 8)).astype(np.float32)).to(
                    torch.float8_e4m3fn),
            "router": torch.from_numpy(rng.random((4, 2)).astype(
                np.float32)),
        },
        "step": torch.tensor(3, dtype=torch.int32),
    }
    manager.save(str(tmp_path), 7, tree)
    restored, _ = manager.restore(str(tmp_path), 7, _zeros_like(tree))
    _assert_trees_equal(tree, restored)
    assert restored["ffn"]["w_gate"].dtype == torch.int8
    assert restored["ffn"]["w_up"].dtype == torch.float8_e4m3fn


def test_restore_rejects_dtype_mismatch(tmp_path):
    tree = {"w": torch.tensor([1, -2, 3], dtype=torch.int8),
            "s": torch.tensor([0.5])}
    manager.save(str(tmp_path), 1, tree)
    wrong = {"w": torch.tensor([1.0, -2.0, 3.0]), "s": torch.tensor([0.5])}
    with pytest.raises(ValueError, match="dtype mismatch"):
        manager.restore(str(tmp_path), 1, wrong)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        m = json.load(f)
    assert m["dtypes"] == ["float32", "int8"]


def test_manifest_is_valid_json(tmp_path):
    manager.save(str(tmp_path), 4, _tree(), meta={"note": "hi"})
    with open(tmp_path / "step_00000004" / "manifest.json") as f:
        m = json.load(f)
    assert m["step"] == 4 and m["num_leaves"] == 5 and m["meta"] == {
        "note": "hi"}


def _corrupt(path, leaf=0, mode="bitflip"):
    f = path / f"a_{leaf:05d}.npy"
    data = bytearray(f.read_bytes())
    if mode == "bitflip":
        data[len(data) // 2] ^= 0x40
    else:
        data = data[: len(data) // 2]
    f.write_bytes(bytes(data))


def test_manifest_records_crc_and_bytes(tmp_path):
    manager.save(str(tmp_path), 1, _tree())
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        m = json.load(f)
    assert len(m["crc32"]) == len(m["nbytes"]) == m["num_leaves"]
    for i, n in enumerate(m["nbytes"]):
        assert (tmp_path / "step_00000001" / f"a_{i:05d}.npy"
                ).stat().st_size == n
    manager.verify(str(tmp_path / "step_00000001"))


def test_verify_catches_bitflip_and_truncation(tmp_path):
    manager.save(str(tmp_path), 1, _tree())
    p = tmp_path / "step_00000001"
    _corrupt(p, leaf=2, mode="bitflip")
    with pytest.raises(manager.CheckpointCorruptError, match="crc32"):
        manager.verify(str(p))
    manager.save(str(tmp_path), 2, _tree())
    p2 = tmp_path / "step_00000002"
    _corrupt(p2, leaf=0, mode="truncate")
    with pytest.raises(manager.CheckpointCorruptError, match="truncated"):
        manager.verify(str(p2))


def test_restore_refuses_corrupt_checkpoint(tmp_path):
    tree = _tree()
    manager.save(str(tmp_path), 1, tree)
    _corrupt(tmp_path / "step_00000001")
    with pytest.raises(manager.CheckpointCorruptError):
        manager.restore(str(tmp_path), 1, _zeros_like(tree))


def test_latest_valid_step_skips_corrupt(tmp_path):
    tree = _tree()
    manager.save(str(tmp_path), 1, tree)
    manager.save(str(tmp_path), 2, tree)
    _corrupt(tmp_path / "step_00000002", mode="truncate")
    assert manager.latest_step(str(tmp_path)) == 2
    assert manager.latest_valid_step(str(tmp_path)) == 1
    assert manager.valid_steps(str(tmp_path)) == [1]
    manager.save(str(tmp_path), 3, tree)
    os.remove(tmp_path / "step_00000003" / "a_00000.npy")
    assert manager.latest_valid_step(str(tmp_path)) == 1
    manager.save(str(tmp_path), 4, tree)
    (tmp_path / "step_00000004" / "manifest.json").write_text("{broken")
    assert manager.latest_valid_step(str(tmp_path)) == 1


def test_pre_integrity_checkpoints_still_verify(tmp_path):
    manager.save(str(tmp_path), 1, _tree())
    mpath = tmp_path / "step_00000001" / "manifest.json"
    m = json.loads(mpath.read_text())
    del m["crc32"], m["nbytes"]
    mpath.write_text(json.dumps(m))
    manager.verify(str(tmp_path / "step_00000001"))
    restored, _ = manager.restore(str(tmp_path), 1, _zeros_like(_tree()))
    _assert_trees_equal(_tree(), restored)


def test_async_post_hook_runs_after_commit(tmp_path):
    seen = []
    saver = manager.AsyncSaver()
    saver.save(str(tmp_path), 5, _tree(),
               post=lambda p: seen.append(
                   (p, manager.latest_step(str(tmp_path)))))
    saver.wait()
    assert seen and seen[0][0].endswith("step_00000005")
    assert seen[0][1] == 5
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("occupied")
    saver.save(str(blocker), 6, _tree(), post=lambda p: seen.append("bad"))
    with pytest.raises(OSError):
        saver.wait()
    assert "bad" not in seen


def test_ckpt_write_fault_site_corrupts_after_commit(tmp_path):
    plan = faults_lib.FaultPlan([
        faults_lib.Fault(site="ckpt.write", kind="truncate", at=1,
                         payload={"leaf": 0}),
    ])
    with faults_lib.scope(plan):
        manager.save(str(tmp_path), 1, _tree())
        manager.save(str(tmp_path), 2, _tree())
    assert plan.fired == [("ckpt.write", 1, "truncate")]
    manager.verify(str(tmp_path / "step_00000001"))
    with pytest.raises(manager.CheckpointCorruptError):
        manager.verify(str(tmp_path / "step_00000002"))
    assert manager.latest_valid_step(str(tmp_path)) == 1


# ---------------------------------------------------------------------------
# the same bytes as the JAX package's
# ---------------------------------------------------------------------------

def _mixed_numpy(seed=0):
    """The mixed tree's leaves as numpy arrays (bf16 / fp8 as ml_dtypes),
    every value drawn from one seed; fp8 from finite bit patterns."""
    rng = np.random.default_rng(seed)
    fp8 = rng.integers(0, 256, size=(3, 4)).astype(np.uint8)
    fp8[(fp8 & 0x7F) == 0x7F] = 0x11          # no NaN patterns
    return {
        "a_f32": rng.normal(size=(4, 8)).astype(np.float32),
        "b_bf16": rng.normal(size=(3, 5)).astype(np.float32).astype(
            ml_dtypes.bfloat16),
        "c_int8": rng.integers(-127, 128, size=(2, 6)).astype(np.int8),
        "d_fp8": fp8.view(ml_dtypes.float8_e4m3fn),
        "e_step": np.asarray(11, np.int32),
    }


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _torch_mixed(seed=0):
    leaves = _mixed_numpy(seed)
    return {"opt": {k: _to_torch(v) for k, v in leaves.items()},
            "master": [None, _to_torch(leaves["a_f32"])]}


def _jax_mixed(seed=0):
    import jax.numpy as jnp

    leaves = _mixed_numpy(seed)
    return {"opt": {k: jnp.asarray(v) for k, v in leaves.items()},
            "master": [None, jnp.asarray(leaves["a_f32"])]}


def test_mixed_tree_bytes_equal_the_jax_package(tmp_path):
    from repro.checkpoint import manager as jmanager

    tp = manager.save(str(tmp_path / "torch"), 5, _torch_mixed(),
                      meta={"step": 5})
    jp = jmanager.save(str(tmp_path / "jax"), 5, _jax_mixed(),
                       meta={"step": 5})
    with open(os.path.join(tp, "manifest.json")) as f:
        tm = json.load(f)
    with open(os.path.join(jp, "manifest.json")) as f:
        jm = json.load(f)
    assert tm["num_leaves"] == jm["num_leaves"] == 6   # the None left out
    assert tm["dtypes"] == jm["dtypes"] == [   # "master" sorts first
        "float32", "float32", "bfloat16", "int8", "float8_e4m3fn", "int32"]
    for k in ("treedef", "process_index"):
        tm.pop(k), jm.pop(k)
    assert tm == jm
    for i in range(6):
        name = f"a_{i:05d}.npy"
        with open(os.path.join(tp, name), "rb") as a, \
                open(os.path.join(jp, name), "rb") as b:
            assert a.read() == b.read(), name


def test_each_package_restores_the_others_checkpoint(tmp_path):
    import jax

    from repro.checkpoint import manager as jmanager

    jmanager.save(str(tmp_path / "jax"), 2, _jax_mixed(1))
    like = _zeros_like(_torch_mixed(0))
    restored, _ = manager.restore(str(tmp_path / "jax"), 2, like)
    _assert_trees_equal(_torch_mixed(1), restored)
    assert restored["master"][0] is None

    manager.save(str(tmp_path / "torch"), 3, _torch_mixed(2))
    jlike = jax.tree.map(lambda x: x * 0, _jax_mixed(0))
    jrestored, _ = jmanager.restore(str(tmp_path / "torch"), 3, jlike)
    for a, b in zip(jax.tree.leaves(jrestored),
                    jax.tree.leaves(_jax_mixed(2))):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
