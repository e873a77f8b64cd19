"""The kernel build's cache key (``hoomd_tf_tpu_torch/_build.py``): a
library is named by a digest of its ``.cu`` source, of the headers that
source includes, and of the flags, so an edit to any of them builds anew.
No ``nvcc`` is needed: the digest is computed from the files alone."""

from hoomd_tf_tpu_torch import _build


def _sources(tmp_path):
    (tmp_path / "stage.cuh").write_text("// staging\n#pragma once\n")
    (tmp_path / "inner.cuh").write_text("// inner\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "stage.cuh"\n'
        '  #  include "inner.cuh"\n__global__ void k() {}\n')
    return tmp_path / "k.cu"


def test_digest_follows_included_headers(tmp_path):
    src = _sources(tmp_path)
    before = _build.source_digest(src)
    assert _build.source_digest(src) == before
    for name in ("stage.cuh", "inner.cuh"):
        hdr = tmp_path / name
        old = hdr.read_bytes()
        hdr.write_bytes(old + b"// edited\n")
        assert _build.source_digest(src) != before, name
        hdr.write_bytes(old)
        assert _build.source_digest(src) == before
    (tmp_path / "other.cuh").write_text("// edited, but not included\n")
    assert _build.source_digest(src) == before


def test_digest_follows_source_and_flags(tmp_path):
    src = _sources(tmp_path)
    before = _build.source_digest(src)
    assert _build.source_digest(src, flags=["-O2"]) != before
    src.write_text(src.read_text() + "// edited\n")
    assert _build.source_digest(src) != before


def test_package_kernels_include_the_shared_staging():
    """K1 and K2 include the shared staging header, so their digests
    cover it."""
    csrc = _build._PKG / "csrc"
    for name in ("cellwise_half", "proxy_bwd"):
        text = (csrc / f"{name}.cu").read_bytes()
        assert b"half_stencil_stage.cuh" in b"".join(
            _build._INCLUDE.findall(text)), name
