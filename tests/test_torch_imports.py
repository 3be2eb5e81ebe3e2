"""The port stands alone: no JAX, entry points default to CUDA, and a
kernel wrapper given CPU tensors runs its plain version."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

import speechsplit_tpu_torch
from speechsplit_tpu.config import SpeechSplitConfig as JaxConfig
from speechsplit_tpu_torch.config import SpeechSplitConfig, resolve_dtype
from speechsplit_tpu_torch.ops import bilstm, multi_bilstm

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "speechsplit_tpu")


def _port_files():
    files = sorted((ROOT / "speechsplit_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in _port_files()}
    assert {"bilstm.py", "multi_bilstm.py", "generator.py", "convert.py",
            "interp.py", "collator.py", "train_step.py", "solver.py",
            "checkpoint.py", "dataset.py", "sampler.py", "loader.py",
            "prefetch.py", "profiling.py", "train.py",
            "stft.py", "filters.py", "pitch.py", "preprocess.py",
            "prepare.py", "vocoder.py", "pipeline.py",
            "serve.py", "linkprobe.py", "chip_smoke.py"} <= names


def test_resolve_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        speechsplit_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        speechsplit_tpu_torch.resolve_device("cuda")
    assert speechsplit_tpu_torch.resolve_device("cpu").type == "cpu"


def test_prepare_utterance_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import numpy as np

    from speechsplit_tpu_torch.convert import prepare_utterance

    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_utterance(SpeechSplitConfig(), np.zeros((10, 80)),
                          np.zeros(10), np.zeros(82))


def test_cpu_tensors_take_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    xp = torch.randn(6, 2, 32, generator=gen)
    w = torch.randn(32, 8, generator=gen)
    got = bilstm.bilstm_sequence(xp, xp, w, w)
    want = bilstm.bilstm_sequence_reference(xp, xp, w, w)
    multi_bilstm.multi_bilstm_sequence(1, xp, xp, w, w)
    # under autograd too: the Functions run the plain versions
    wg = w.clone().requires_grad_(True)
    bilstm.bilstm_sequence(xp, xp, wg, wg)[0].sum().backward()
    multi_bilstm.multi_bilstm_sequence(1, xp, xp, wg, wg)[0].sum().backward()
    assert not any(bilstm.LAUNCHES.values())
    assert not any(multi_bilstm.LAUNCHES.values())
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_wrappers_refuse_bfloat16_on_cuda_path():
    """The dtype checks before a launch: the ops take every
    float32/bfloat16 set of xp and W_hh, as JAX's ops take them all, and
    map each onto a set a kernel instance takes (``kernel_set``: the set
    itself, or xp widened and, beside a bfloat16 W_hh, float32 residuals);
    the kernel wrappers refuse any other set, and the multi-stream ones a
    bfloat16 xp (the op widens it); another dtype raises."""
    bf16, f32 = torch.bfloat16, torch.float32
    xp = torch.zeros(4, 1, 32, dtype=bf16)
    w = torch.zeros(32, 8, dtype=bf16)
    bilstm._check(xp, xp, w, w)
    for xp_dtype in (bf16, f32):
        for w_dtype in (bf16, f32):
            bilstm.check_compute(xp_dtype, w_dtype)
            for rd in (None, f32, bf16):
                kx, kr = bilstm.kernel_set(xp_dtype, w_dtype, rd)
                bilstm.check_kernel_set(kx, w_dtype, kr)
                assert kr in (rd, f32)
                if (kx, kr) != (xp_dtype, rd):
                    with pytest.raises(ValueError, match="nowhere"):
                        bilstm.check_kernel_set(xp_dtype, w_dtype, rd)
    assert bilstm.kernel_set(bf16, f32, bf16) == (f32, bf16)
    assert bilstm.kernel_set(f32, bf16, bf16) == (f32, f32)
    assert bilstm.kernel_set(bf16, bf16, None) == (bf16, None)
    for rd, dh, dx, want in ((bf16, bf16, bf16, bf16), (f32, f32, f32, f32),
                             (bf16, f32, bf16, f32), (bf16, bf16, f32, f32)):
        assert bilstm.kernel_streams(rd, dh, dx) == want
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bilstm.check_compute(torch.float16, w.dtype)
    multi_bilstm.compute_plan((xp, xp.float()), (w, w.float()))
    multi_bilstm._check(1, (xp.float(), xp.float()), (w, w))
    with pytest.raises(ValueError, match="float32 xp"):
        multi_bilstm._check(1, (xp, xp), (w, w))


def test_default_config_equals_jax():
    from speechsplit_tpu.config import default_config as jax_default
    from speechsplit_tpu_torch.config import default_config

    assert dataclasses.asdict(default_config()) == dataclasses.asdict(
        jax_default())
    assert default_config() == SpeechSplitConfig()


def test_ops_exports_equal_jax():
    import speechsplit_tpu.ops as jax_ops
    import speechsplit_tpu_torch.ops as ops

    assert ops.__all__ == jax_ops.__all__
    assert all(callable(getattr(ops, name)) or name == "UNVOICED_LOG_F0"
               for name in ops.__all__)
    assert ops.UNVOICED_LOG_F0 == jax_ops.UNVOICED_LOG_F0


def test_config_fields_and_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(SpeechSplitConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == theirs
    spec = "dim_neck=4,samplier=3,mesh_shape=[2,4],root_dir=a/b"
    assert dataclasses.asdict(SpeechSplitConfig().parse(spec)) == (
        dataclasses.asdict(JaxConfig().parse(spec))
    )
    with pytest.raises(ValueError):
        SpeechSplitConfig().parse("no_such_key=1")
    assert resolve_dtype("float32") is torch.float32
    assert resolve_dtype("bfloat16") is torch.bfloat16


def test_corpus_and_vocoder_trainer_default_to_cuda(monkeypatch, tmp_path):
    """Corpus preparation and the vocoder's trainer run on CUDA unless
    told otherwise, and refuse when there is none."""
    from speechsplit_tpu_torch.cli import preprocess as cli_preprocess
    from speechsplit_tpu_torch.cli import train_vocoder as cli_train_vocoder
    from speechsplit_tpu_torch.data.prepare import extract_dir
    from speechsplit_tpu_torch.vocoder_neural import VocoderTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "wavs").mkdir()
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_dir(str(tmp_path / "wavs"), str(tmp_path / "mel"),
                    str(tmp_path / "f0"), {})
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_preprocess.main(["--wav_dir", str(tmp_path / "wavs")])
    with pytest.raises(RuntimeError, match="CUDA"):
        VocoderTrainer()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_train_vocoder.main(["--wav_dir", str(tmp_path / "wavs")])


def test_scan_covers_the_corpus_and_vocoder_trainer():
    names = {p.name for p in _port_files()}
    assert {"prepare.py", "preprocess.py", "metadata.py",
            "train_vocoder.py", "vocoder_neural.py"} <= names


def test_scan_covers_the_resident_data():
    names = {p.name for p in _port_files()}
    assert {"resident.py", "prefetch.py", "train_step.py", "solver.py",
            "profiling.py"} <= names


def test_scan_covers_the_parallel_package():
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"speechsplit_tpu_torch/parallel/__init__.py",
            "speechsplit_tpu_torch/parallel/distributed.py",
            "speechsplit_tpu_torch/parallel/mesh.py"} <= files


def test_scan_covers_the_front_end():
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"speechsplit_tpu_torch/ops/filters.py",
            "speechsplit_tpu_torch/ops/pitch.py",
            "speechsplit_tpu_torch/ops/pitch_native.py",
            "speechsplit_tpu_torch/data/synthetic.py"} <= files


def test_resident_store_defaults_to_cuda(monkeypatch, tmp_path):
    """The device-resident store, built from features or from wavs, runs
    on CUDA unless told otherwise, and refuses when there is none."""
    from speechsplit_tpu_torch.data.resident import (
        build_resident,
        build_resident_from_wavs,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_resident(None, SpeechSplitConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_resident_from_wavs(str(tmp_path), {}, SpeechSplitConfig())
