"""The F0 converter's default-config train step at ``dim_neck_3`` = 40
and 72, and the SpeechSplit step at 72 (each encoder's own layer),
against the JAX package's (tests/test_torch_wide_neck_step.py states the
set-up and the bars)."""

import pytest

from tests.test_torch_compute_bf16 import interpret
from tests.test_torch_training import gather_form  # noqa: F401 (autouse)
from tests.test_torch_wide_neck_step import check_wide_step


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    interpret(monkeypatch)


@pytest.mark.parametrize("neck", [40, 72])
def test_f0_step_matches_jax(monkeypatch, neck):
    check_wide_step(monkeypatch, "f0_converter", neck)


def test_generator_step_past_the_kernels_matches_jax(monkeypatch):
    check_wide_step(monkeypatch, "speechsplit", 72)
