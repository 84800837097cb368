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
    assert {"knn.cu", "frustum_lm.cu", "nn1.cu"} <= names
    assert names == {p.name for p in _build.SRC_DIR.glob("*.cu")}
    out = _build.library_path(srcs)
    # one compile command per source, started together, then one link
    # command that puts every object into the one library
    compiles, link = _build.nvcc_commands("nvcc", srcs, out)
    assert len(compiles) == len(srcs)
    objs = []
    for src, cmd in zip(srcs, compiles):
        assert cmd[0] == "nvcc" and cmd[-1] == str(src)
        i = cmd.index("-gencode")
        assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
        for flag in ("-c", "-std=c++17", "-O3", "-fPIC", "-fmad=false"):
            assert flag in cmd
        assert cmd[cmd.index("-Xptxas") + 1] == "-v"
        assert [c for c in cmd if c.endswith(".cu")] == [str(src)]
        objs.append(cmd[cmd.index("-o") + 1])
    assert len(set(objs)) == len(srcs)
    assert all(Path(o).parent == out.parent for o in objs)
    assert link[0] == "nvcc" and "-shared" in link
    assert link[link.index("-o") + 1] == str(out)
    assert link[link.index("-o") + 2:] == objs


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
