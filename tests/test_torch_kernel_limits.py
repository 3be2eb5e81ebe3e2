"""Every BiLSTM layer the main paths send to the merged kernels stays
inside the limits the kernel sources state (``ops.bilstm`` reads them
with ``_build.source_constant``): both train steps at B16 under autograd
(``bilstm_fwd`` and ``bilstm_bwd``), the 4-pair conversion (batch 28;
the F0 converter's decoder at 4), and the fused 8-pair conversion and
train steps under ``PROJ_FUSION = "auto"``."""

import pytest
import torch

from speechsplit_tpu_torch.config import SpeechSplitConfig
from speechsplit_tpu_torch.models import F0Converter, SpeechSplit
from speechsplit_tpu_torch.models.layers import LSTM
from speechsplit_tpu_torch.ops import bilstm

T = 192
TRAIN_B = 16
# (H, I) of every layer the merged kernels run: content layer 1, the mel
# decoder's three layers, the F0 decoder's two. The narrow encoders'
# first layers run as multi-stream kernels.
MERGED_LAYERS = ((8, 16), (512, 164), (512, 1024), (256, 66), (256, 512))


def _rows(h: int, pairs: int) -> int:
    """A conversion's batch at a layer: the generator runs 7 conditions a
    pair, the F0 converter (the H=256 decoder) one row a pair."""
    return pairs if h == 256 else 7 * pairs


def test_merged_layers_are_the_models_own():
    gen = torch.Generator().manual_seed(0)
    config = SpeechSplitConfig()
    found = set()
    for model in (SpeechSplit(config, generator=gen),
                  F0Converter(config, generator=gen)):
        for module in model.modules():
            if not isinstance(module, LSTM):
                continue
            for layer in range(module.num_layers):
                if layer == 0 and module.hidden_size <= 64:
                    continue  # a multi-stream layer
                i = getattr(module, f"weight_ih_l{layer}").shape[1]
                found.add((module.hidden_size, i))
    assert found == set(MERGED_LAYERS)


@pytest.mark.parametrize("h,i", MERGED_LAYERS)
@pytest.mark.parametrize("path", ["train", "convert", "fused_convert",
                                  "fused_train"])
def test_main_path_layer_fits_the_kernels(monkeypatch, path, h, i):
    monkeypatch.setattr(bilstm, "PROJ_FUSION",
                        "auto" if path.startswith("fused") else "off")
    grad = path.endswith("train")
    b = TRAIN_B if grad else _rows(h, 8 if path == "fused_convert" else 4)
    assert bilstm.merged_bidir_fits(T, b, h, grad=grad)
    assert b <= bilstm.merged_max_batch(h, grad=grad)
    fused = bilstm.fused_proj_plan(T, b, h, i, torch.float32)
    assert fused == path.startswith("fused")
    if fused:
        assert b <= bilstm.MAX_FUSED_BATCH
