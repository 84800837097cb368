"""The kernel build: one nvcc command for every CUDA source, for sm_90a,
into a shared library that git ignores.  Runs without nvcc."""
import subprocess
from pathlib import Path

import jax  # noqa: F401  (port tests hold both frameworks)
import pytest
import torch  # noqa: F401

from deepi2p_tpu_torch import _build

REPO = Path(__file__).resolve().parents[1]


def test_one_nvcc_command_for_all_sources():
    srcs = _build.sources()
    names = {p.name for p in srcs}
    assert {"knn.cu", "frustum_lm.cu"} <= names
    assert names == {p.name for p in _build.SRC_DIR.glob("*.cu")}
    out = _build.library_path(srcs)
    cmd = _build.nvcc_command("nvcc", srcs, out)
    assert cmd[0] == "nvcc"
    i = cmd.index("-gencode")
    assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-shared", "-std=c++17", "-O3", "-fPIC"):
        assert flag in cmd
    assert cmd[cmd.index("-Xptxas") + 1] == "-v"
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert [c for c in cmd if c.endswith(".cu")] == [str(p) for p in srcs]


def test_sources_use_no_torch_headers():
    for p in _build.sources():
        text = p.read_text()
        assert "torch/extension.h" not in text and "ATen" not in text, p
        assert 'extern "C"' in text, p


def test_library_name_follows_the_sources(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("// one\n")
    first = _build.library_path([a])
    a.write_text("// two\n")
    assert _build.library_path([a]) != first
    assert first.parent == _build.BUILD_DIR
    assert first.suffix == ".so"


def test_library_path_is_ignored_by_git():
    lib = _build.library_path().relative_to(REPO)
    tmp = lib.with_name(lib.name + ".tmp123")
    out = subprocess.run(["git", "check-ignore", "-q", str(lib), str(tmp)],
                         cwd=REPO, capture_output=True, text=True)
    if out.returncode == 128:       # not a git checkout: read the rule
        rules = (REPO / ".gitignore").read_text().split()
        assert "build/" in rules and "build" in lib.parts
    else:
        assert out.returncode == 0, out.stderr


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()
