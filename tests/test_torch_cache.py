"""``repro_torch.common.cache``: the kernels' build directory under
``$REPRO_CACHE_DIR/cuda_kernels`` (default ``.cache/``), off under
``REPRO_COMPILATION_CACHE=0`` (as ``repro.common.cache`` turns off JAX's
compilation cache), the entry count of built libraries, and
``build/kernels/`` as the build directory when it is never called."""
import os
from pathlib import Path

import pytest

from repro_torch.common import cache
from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def build_dir(monkeypatch):
    """Restores ``build.BUILD_DIR`` after the test."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    return build


def test_default_build_directory_is_build_kernels():
    assert build.BUILD_DIR == ROOT / "build" / "kernels"


def test_default_cache_dir_follows_repro_cache_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    assert cache.default_cache_dir() == os.path.join(".cache",
                                                     "cuda_kernels")
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    assert cache.default_cache_dir() == str(tmp_path / "cuda_kernels")


def test_enable_points_the_build_there(monkeypatch, tmp_path, build_dir):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_COMPILATION_CACHE", raising=False)
    got = cache.enable_compilation_cache()
    assert got == str(tmp_path / "cuda_kernels")
    assert Path(got).is_dir() and build_dir.BUILD_DIR == Path(got)
    other = tmp_path / "other"
    assert cache.enable_compilation_cache(str(other)) == str(other)
    assert build_dir.BUILD_DIR == other       # the last directory wins


def test_disabled_leaves_the_build_alone(monkeypatch, tmp_path, build_dir):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_COMPILATION_CACHE", "0")
    before = build_dir.BUILD_DIR
    assert cache.enable_compilation_cache() is None
    assert build_dir.BUILD_DIR == before
    assert not (tmp_path / "cuda_kernels").exists()


def test_entries_count_built_libraries(tmp_path):
    d = tmp_path / "cuda_kernels"
    assert cache.compilation_cache_entries(str(d)) == 0   # no directory
    d.mkdir()
    for name in ("libflash_decode_0123456789ab.so",
                 "libcc_update_ba9876543210.so", "libx.so.4242.tmp",
                 ".hidden", "notes.txt"):
        (d / name).write_text("")
    assert cache.compilation_cache_entries(str(d)) == 2
