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


def test_decode_header_edit_rebuilds_its_three_libraries(fake, monkeypatch):
    """csrc/decode_common.cuh is included by the run-decode (#13), the
    append (#12) and the read-only block-table (#11) launchers: an edit of
    it rebuilds those three libraries and no other."""
    import shutil

    fake_csrc, compiles = fake
    real = _native._PKG / "csrc"
    users = sorted(p.name for p in real.glob("*.cu")
                   if real / "decode_common.cuh" in _native._headers(p))
    assert users == ["decode_attention.cu", "paged_append_attention.cu",
                     "paged_attention.cu"]
    for p in real.iterdir():
        shutil.copy(p, fake_csrc / p.name)
    kernels = [_native.CudaKernel(p.name, {})
               for p in sorted(fake_csrc.glob("*.cu"))]
    _native.build_all(kernels)
    assert "fused.cu" in compiles()
    header = fake_csrc / "decode_common.cuh"
    header.write_text(header.read_text() + "// edited\n")
    _native.build_all(kernels)
    assert compiles() == users


def test_flash_fwd_hash_covers_its_headers(fake):
    """kernel #1's library is keyed by every csrc/*.cuh that flash_fwd.cu
    includes: the Hopper primitives (hopper.cuh), the fp32 body
    (flash_fwd.cuh) and what that includes; an edit of hopper.cuh
    rebuilds flash_fwd.cu and no library that does not include it."""
    import shutil

    fake_csrc, compiles = fake
    real = _native._PKG / "csrc"
    names = {p.name for p in _native._headers(real / "flash_fwd.cu")}
    assert {"hopper.cuh", "flash_fwd.cuh", "flash_common.cuh"} <= names
    assert all((real / n).exists() for n in names)
    users = sorted(p.name for p in real.glob("*.cu")
                   if real / "hopper.cuh" in _native._headers(p))
    assert "flash_fwd.cu" in users
    for p in real.iterdir():
        shutil.copy(p, fake_csrc / p.name)
    kernels = [_native.CudaKernel(p.name, {})
               for p in sorted(fake_csrc.glob("*.cu"))]
    _native.build_all(kernels)
    assert "flash_fwd.cu" in compiles()
    before = _native.CudaKernel("flash_fwd.cu", {}).so_path()
    header = fake_csrc / "hopper.cuh"
    header.write_text(header.read_text() + "// edited\n")
    _native.build_all(kernels)
    assert compiles() == users
    assert _native.CudaKernel("flash_fwd.cu", {}).so_path() != before


def test_flash_fwd_argtypes_unchanged():
    """The C entry of kernel #1 keeps its interface: q, k, v, bias, mask,
    out, lse as pointers, then B, T, S, H, D, bias_sb, bias_sh, q_offset,
    limit, causal, window, dtype as ints, then the stream."""
    from unilm_tpu_torch.ops import flash_attention as tfa

    P, I = _native.P, _native.I
    assert tfa.KERNEL.source.name == "flash_fwd.cu"
    assert tfa.KERNEL.functions == {"flash_fwd": [P] * 7 + [I] * 12 + [P]}


def test_flash_bwd_hash_covers_its_headers(fake):
    """kernels #6/#7's library is keyed by every csrc/*.cuh that
    flash_bwd.cu includes: the Hopper primitives (hopper.cuh), the fp32
    bodies (flash_bwd.cuh, which #8 shares) and what they include; an edit
    of hopper.cuh or flash_bwd.cuh rebuilds flash_bwd.cu with the other
    libraries that include the header, and no other."""
    import shutil

    fake_csrc, compiles = fake
    real = _native._PKG / "csrc"
    names = {p.name for p in _native._headers(real / "flash_bwd.cu")}
    assert {"hopper.cuh", "flash_bwd.cuh", "flash_common.cuh",
            "mma_common.cuh"} <= names
    assert all((real / n).exists() for n in names)
    for p in real.iterdir():
        shutil.copy(p, fake_csrc / p.name)
    kernels = [_native.CudaKernel(p.name, {})
               for p in sorted(fake_csrc.glob("*.cu"))]
    _native.build_all(kernels)
    assert "flash_bwd.cu" in compiles()
    for header in ("hopper.cuh", "flash_bwd.cuh"):
        users = sorted(p.name for p in real.glob("*.cu")
                       if real / header in _native._headers(p))
        assert "flash_bwd.cu" in users
        before = _native.CudaKernel("flash_bwd.cu", {}).so_path()
        path = fake_csrc / header
        path.write_text(path.read_text() + "// edited\n")
        _native.build_all(kernels)
        assert compiles() == users
        assert _native.CudaKernel("flash_bwd.cu", {}).so_path() != before
    assert "flash_bwd_fused.cu" in users  # #8's fp32 path shares the body


def test_flash_bwd_argtypes_unchanged():
    """The C entries of kernels #6 and #7 keep their interface, which the
    ring's chunked backward relies on (out and lse from the caller):
    q, k, v, dout, lse, delta, bias, mask, then dq, dbias (#6) or dk, dv
    (#7) as pointers; B, T, S, H, D, bias_sb, bias_sh, q_offset, limit,
    causal, window, [acc_b, delta_mode,] dtype as ints; then the stream.
    #6's `delta_mode` says whether it takes delta itself or the caller's
    (the ring's chunks pass theirs)."""
    from unilm_tpu_torch.ops import flash_attention as tfa

    P, I = _native.P, _native.I
    assert tfa.BWD_KERNEL_DQ.source.name == "flash_bwd.cu"
    assert tfa.BWD_KERNEL_DKV.source.name == "flash_bwd.cu"
    assert tfa.BWD_KERNEL_DQ.functions == {
        "flash_bwd_dq": [P] * 10 + [I] * 14 + [P]}
    assert tfa.BWD_KERNEL_DKV.functions == {
        "flash_bwd_dkv": [P] * 10 + [I] * 12 + [P]}


@pytest.mark.parametrize("source,header", [
    ("flash_tri.cu", "hopper.cuh"), ("encoder_attention.cu", "hopper.cuh"),
    ("encoder_attention.cu", "encoder_attention.cuh")])
def test_hopper_tri_and_encoder_hash_covers_their_headers(fake, source,
                                                          header):
    """kernels #2 and #3 (bf16: wgmma, TMA) include the Hopper primitives
    (hopper.cuh), and #3 keeps its fp32 body in encoder_attention.cuh
    (shared with #9's fp32 path): an edit of either header rebuilds the
    library with exactly the other libraries that include it."""
    import shutil

    fake_csrc, compiles = fake
    real = _native._PKG / "csrc"
    assert real / header in _native._headers(real / source)
    users = sorted(p.name for p in real.glob("*.cu")
                   if real / header in _native._headers(p))
    if header == "encoder_attention.cuh":
        assert users == ["doc_attention.cu", "encoder_attention.cu"]
    for p in real.iterdir():
        shutil.copy(p, fake_csrc / p.name)
    kernels = [_native.CudaKernel(p.name, {})
               for p in sorted(fake_csrc.glob("*.cu"))]
    _native.build_all(kernels)
    assert source in compiles()
    before = _native.CudaKernel(source, {}).so_path()
    path = fake_csrc / header
    path.write_text(path.read_text() + "// edited\n")
    _native.build_all(kernels)
    assert compiles() == users
    assert _native.CudaKernel(source, {}).so_path() != before


def test_tri_and_encoder_argtypes_unchanged():
    """The C entries of kernels #2 and #3 keep their interfaces: #2 q, k,
    v, bias, mask, out, lse as pointers, B, T, H, D, bias_sb, bias_sh,
    dtype as ints, the stream; #3 q, k, v, bias, out as pointers, B, T, S,
    H, D, bias_sb, bias_sh as ints, scale as a float, dtype, the stream."""
    from unilm_tpu_torch.ops import flash_attention as tfa

    P, I, F = _native.P, _native.I, _native.F
    assert tfa.TRI_KERNEL.functions == {"flash_tri_fwd": [P] * 7 + [I] * 7
                                        + [P]}
    assert tfa.ENCODER_KERNEL.functions == {
        "encoder_attn_fwd": [P] * 5 + [I] * 7 + [F, I, P]}
