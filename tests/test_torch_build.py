"""The port's kernel build (``repro_torch/kernels/_build.py``) names each
library by a hash of its source, of every shared ``csrc/*.cuh`` header
and of the nvcc flags, so an edit to any of them rebuilds.  No nvcc is
needed: only the library's path is computed."""
from repro_torch.kernels import _build


def _fake_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n__global__ void f() {}\n')
    (csrc / "common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return csrc


def test_header_edit_changes_library_path(tmp_path, monkeypatch):
    csrc = _fake_csrc(tmp_path, monkeypatch)
    before = _build.library_path("k")
    assert before.parent == tmp_path / "_build"
    assert before.name.startswith("k-") and before.suffix == ".so"
    assert _build.library_path("k") == before          # stable
    (csrc / "common.cuh").write_text("#pragma once\n// edited\n")
    after = _build.library_path("k")
    assert after != before
    assert _build.build_log("k") == after.with_suffix(".log")


def test_source_edit_new_header_and_flags_change_library_path(tmp_path,
                                                             monkeypatch):
    csrc = _fake_csrc(tmp_path, monkeypatch)
    seen = {_build.library_path("k")}
    (csrc / "k.cu").write_text("__global__ void g() {}\n")
    seen.add(_build.library_path("k"))
    (csrc / "other.cuh").write_text("#pragma once\n")
    seen.add(_build.library_path("k"))
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    seen.add(_build.library_path("k"))
    assert len(seen) == 4
