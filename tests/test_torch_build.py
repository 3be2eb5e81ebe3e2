"""The kernel build's cache key: a library is named by a hash of its
source, the ``csrc/*.cuh`` headers the source includes, and the flags, so
an edited header rebuilds every source that includes it."""

import pytest

from speechsplit_tpu_torch.ops import _build


def test_target_changes_with_an_included_header(tmp_path):
    header = tmp_path / "shared.cuh"
    source = tmp_path / "kernel.cu"
    header.write_text("// first\n")
    source.write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\n')
    assert _build._headers(source) == [header]
    before = _build._target(source)
    header.write_text("// second\n")
    assert _build._target(source) != before
    assert _build._target(source).name.startswith("libkernel_")


@pytest.mark.parametrize("stem", ["bilstm_infer", "bilstm_bwd"])
def test_merged_sources_share_the_step_header(stem):
    headers = _build._headers(_build.CSRC / f"{stem}.cu")
    # the step header, and the residual element type's
    assert [p.name for p in headers] == ["merged_step.cuh", "resid.cuh"]
    assert all(p.exists() for p in headers)


def test_target_changes_with_a_header_a_header_includes(tmp_path):
    inner = tmp_path / "inner.cuh"
    outer = tmp_path / "outer.cuh"
    source = tmp_path / "kernel.cu"
    inner.write_text("// first\n")
    outer.write_text('#pragma once\n#include "inner.cuh"\n')
    source.write_text('#include "outer.cuh"\n#include "inner.cuh"\n')
    assert _build._headers(source) == [outer, inner]
    before = _build._target(source)
    inner.write_text("// second\n")
    assert _build._target(source) != before


@pytest.mark.parametrize("stem", ["lstm_infer", "lstm_bwd",
                                  "multi_bilstm_infer", "multi_bilstm_bwd"])
def test_lane_sources_hash_the_residual_header(stem):
    names = [p.name for p in _build._headers(_build.CSRC / f"{stem}.cu")]
    assert "resid.cuh" in names
