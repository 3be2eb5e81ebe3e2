"""bfloat16 compute in the F0 converter's train step and in ``cli.train``
(the bars of tests/test_torch_compute_bf16_step.py, stated there)."""

import os

import pytest
import torch

from speechsplit_tpu_torch.cli import train as cli_train
from speechsplit_tpu_torch.training import checkpoint as ckpt_lib
from speechsplit_tpu_torch.training import create_train_state
from tests.test_torch_compute_bf16 import interpret
from tests.test_torch_compute_bf16_step import BF, check_bf16_step
from tests.test_torch_data import write_feature_tree
from tests.test_torch_training import gather_form  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


def test_f0_step_bf16_matches_jax(monkeypatch):
    check_bf16_step(monkeypatch, "f0_converter")


@pytest.mark.parametrize("model", ["speechsplit", "f0_converter"])
def test_cli_trains_at_bf16_compute(tmp_path, model):
    """``cli.train --hparams compute_dtype=bfloat16`` (tiny widths): the
    models are built at bfloat16 with float32 parameters, two steps
    train to a finite loss, the checkpoint resumes into a state equal to
    the file's, and one more step runs."""
    tree = write_feature_tree(str(tmp_path / "feats"), 3, 2, seed=3)
    widths = ",".join(f"{k}={getattr(BF, k)}" for k in (
        "dim_enc", "dim_enc_2", "dim_enc_3", "dim_neck", "dim_neck_2",
        "dim_neck_3", "dim_dec_mel", "dim_dec_f0", "max_len_pad",
        "max_len_seq", "min_len_seq"))

    def args(*extra):
        return ["--device", "cpu", "--log_step", "1", "--sample_step", "1000",
                "--model", model,
                "--model_save_dir", str(tmp_path / "models"),
                "--sample_dir", str(tmp_path / "samples"),
                "--log_dir", str(tmp_path / "logs"),
                "--validation_path", str(tmp_path / "missing.pkl"),
                "--hparams", f"root_dir={tree[0]},feat_dir={tree[1]},"
                f"batch_size=4,compute_dtype=bfloat16,{widths}", *extra]

    state = cli_train.main(args("--num_iters", "2", "--model_save_step", "2"))
    assert state.step == 2
    assert state.model.decoder.lstm.dtype == torch.bfloat16
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    models = str(tmp_path / "models")
    tag = "G" if model == "speechsplit" else "P"
    saved = torch.load(os.path.join(models, f"2-{tag}.ckpt"),
                       map_location="cpu", weights_only=True)
    resumed = create_train_state(BF, 0, model, device="cpu")
    ckpt_lib.restore_checkpoint(models, 2, resumed, tag)
    for key, p in resumed.model.named_parameters():
        assert torch.equal(p.detach(), saved["model"][key]), key
    state = cli_train.main(args("--resume_iters", "2", "--num_iters", "1",
                                "--model_save_step", "3"))
    assert state.step == 3
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
