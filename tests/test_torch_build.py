"""The port's kernel build module (``repro_torch.kernels.build``): what
names a built library. nvcc is not run here; only the content tag is tested."""
import shutil

from repro_torch.kernels import build


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    return csrc


def test_every_kernel_source_is_listed():
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == \
        sorted(build.KERNELS)


def test_library_tag_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ names a new library for every kernel,
    so no stale build loads; an unchanged tree names the same one."""
    csrc = _copy_csrc(tmp_path, monkeypatch)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc/ has no shared header"
    before = {name: build.library_path(name) for name in build.KERNELS}
    assert before == {name: build.library_path(name)
                      for name in build.KERNELS}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.KERNELS}
    assert all(after[name] != before[name] for name in build.KERNELS)


def test_library_tag_follows_the_source_and_a_new_header(tmp_path,
                                                         monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    esmm, estmm = build.library_path("esmm"), build.library_path("estmm")
    src = csrc / "esmm.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("esmm") != esmm
    assert build.library_path("estmm") == estmm
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("estmm") != estmm
