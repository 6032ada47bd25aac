"""The CUDA build cache of unilm_tpu_torch.ops._native, with a fake `nvcc`
on PATH: a script that records its calls and writes the output file.

A library is keyed by a hash of its .cu source, the csrc/*.cuh headers it
includes (transitively), NVCC_FLAGS and `nvcc --version`. Editing a
header rebuilds exactly the libraries that include it; a rebuild of an
unchanged tree, or a new mtime alone, compiles nothing.
"""

import os
import stat

import pytest

from unilm_tpu_torch.ops import _native

FAKE_NVCC = """#!/usr/bin/env python3
import os, sys
args = sys.argv[1:]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(" ".join(args) + "\\n")
if args == ["--version"]:
    print(os.environ.get("FAKE_NVCC_VERSION", "fake nvcc 12.8"))
    sys.exit(0)
src = args[-1]
if "broken" in open(src).read():
    sys.stderr.write("error: broken source\\n")
    sys.exit(2)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built from " + src)
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_native, "_NVCC_VERSION", {})
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "inner.cuh").write_text("// inner v1\n")
    (csrc / "common.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "a.cu").write_text('#include "common.cuh"\n// a\n')
    (csrc / "b.cu").write_text("#include <cuda_runtime.h>\n// b\n")
    monkeypatch.setattr(_native, "CSRC", csrc)
    monkeypatch.setattr(_native, "BUILD", tmp_path / "build")

    def compiles():
        if not log.exists():
            return []
        lines = log.read_text().splitlines()
        log.write_text("")
        return sorted(os.path.basename(line.split()[-1]) for line in lines
                      if line != "--version")

    return csrc, compiles


def test_header_edit_rebuilds_only_its_users(fake, monkeypatch):
    csrc, compiles = fake
    ka = _native.CudaKernel("a.cu", {})
    kb = _native.CudaKernel("b.cu", {})
    assert _native._headers(ka.source) == sorted(
        [csrc / "common.cuh", csrc / "inner.cuh"])
    pa, pb = _native.build_all([ka, kb])
    assert compiles() == ["a.cu", "b.cu"]
    assert pa.exists() and pb.exists()
    assert pa.name.startswith("a.") and pa.suffix == ".so"

    # nothing changed (a new mtime alone is not a change): no compile
    os.utime(csrc / "inner.cuh")
    assert _native.build_all([ka, kb]) == [pa, pb]
    assert ka.ensure_built() == pa
    assert compiles() == []

    # a header two includes deep: a rebuilds under a new name, b does not
    (csrc / "inner.cuh").write_text("// inner v2\n")
    pa2, pb2 = _native.build_all([ka, kb])
    assert compiles() == ["a.cu"]
    assert pa2 != pa and pb2 == pb and pa2.exists()

    # a change of flags or of the compiler rebuilds both
    monkeypatch.setattr(_native, "NVCC_FLAGS", _native.NVCC_FLAGS + ["-G"])
    pa3, pb3 = _native.build_all([ka, kb])
    assert compiles() == ["a.cu", "b.cu"]
    assert pa3 != pa2 and pb3 != pb
    monkeypatch.setattr(_native, "_NVCC_VERSION", {})
    monkeypatch.setenv("FAKE_NVCC_VERSION", "fake nvcc 12.9")
    _native.build_all([ka, kb])
    assert compiles() == ["a.cu", "b.cu"]


def test_two_launchers_of_one_source_build_once(fake):
    _, compiles = fake
    k1 = _native.CudaKernel("a.cu", {"f": []})
    k2 = _native.CudaKernel("a.cu", {"g": []})
    p1, p2 = _native.build_all([k1, k2])
    assert p1 == p2 and compiles() == ["a.cu"]


def test_failed_build_raises_with_stderr(fake):
    csrc, compiles = fake
    (csrc / "bad.cu").write_text("broken\n")
    bad = _native.CudaKernel("bad.cu", {})
    with pytest.raises(RuntimeError, match="(?s)bad.cu.*broken source"):
        _native.build_all([bad, _native.CudaKernel("b.cu", {})])
    assert not bad.so_path().exists()
    assert not list((_native.BUILD).glob("*.tmp.so"))
