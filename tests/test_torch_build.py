"""Where the port's kernels are built: the library's name carries a hash of
its source, of every ``csrc/*.cuh`` header the source includes and of the
compiler flags, so an edited header is rebuilt rather than a stale library
loaded. Nothing here needs a compiler."""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    return csrc


def test_headers_are_the_ones_a_source_includes(csrc_copy):
    for name in ("flash_attention", "decode_attention", "ssd_scan",
                 "rglru_scan"):
        assert _build.headers(csrc_copy / f"{name}.cu") == [
            csrc_copy / "hopper.cuh"]
    assert _build.headers(csrc_copy / "policy_score.cu") == []


def test_headers_follow_includes_of_includes(csrc_copy):
    (csrc_copy / "inner.cuh").write_text("// included by hopper.cuh\n")
    with open(csrc_copy / "hopper.cuh", "a") as f:
        f.write('\n#include "inner.cuh"\n')
    assert _build.headers(csrc_copy / "flash_attention.cu") == [
        csrc_copy / "hopper.cuh", csrc_copy / "inner.cuh"]


@pytest.mark.parametrize("name", _build.SOURCES)
def test_editing_an_included_header_changes_the_library_path(csrc_copy,
                                                             name):
    src = csrc_copy / f"{name}.cu"
    before = _build.library_path(name)
    with open(csrc_copy / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = _build.library_path(name)
    if csrc_copy / "hopper.cuh" in _build.headers(src):
        assert after != before
    else:
        assert after == before
    assert after.name.startswith(f"{name}-") and after.suffix == ".so"


def test_the_path_depends_on_content_not_place(csrc_copy, monkeypatch):
    copied = _build.library_path("flash_attention")
    monkeypatch.undo()
    assert _build.library_path("flash_attention") == copied
