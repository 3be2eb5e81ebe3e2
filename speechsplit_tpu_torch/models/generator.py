"""Top-level models (counterpart of speechsplit_tpu/models/generator.py).

Reference: Generator_3 model.py:283-320 (19,437,800 params at defaults)
and Generator_6 model.py:324-351 (3,485,849 params). Submodules carry
the reference's names (``encoder_1``/``encoder_2``/``encoder_3``/
``decoder``), so ``state_dict()`` keys are the reference's.

The forward takes the streams structure of the JAX generator's fused
path (generator.py:124-149, :210-227) wherever the multi-stream kernels
hold the encoders' widths (``ops.multi_bilstm.fits``): conv stacks, then
every independent encoder recurrence in one ``ops.multi_bilstm``
launch, then content layer 1 through ``ops.bilstm``, then code
sampling. Elsewhere (a bottleneck wider than the kernels'
``MAX_HIDDEN``) each encoder runs its own ``LSTM``, as the JAX
generator's ``else`` branches do (generator.py:150-154, :228-232): the
content stack's two layers, pitch, rhythm and f0 each through the merged
kernels, or the single-direction route where those refuse the batch.
The JAX package gates that structure on backend, batch and a VMEM
budget (``_fuse_encoder_group``); the port gates it on the widths alone,
so the CPU tests and the card run the same route. Both routes compute
the same sums.

``train=True`` turns on the encoders' random resampling, whose draws
come from the ``generator`` argument in the JAX order: content/pitch
conv pairs 0, 1, 2 (SpeechSplit), f0 convs 0, 1, 2 (F0Converter); a
rank of a data-parallel world passes its rows' ``example_ids`` and the
``global_batch`` (JAX generator.py:93-231, ``ops.interp``). Under
autograd the recurrences run their training kernels (``ops.bilstm``),
saving residuals in ``config.residual_dtype``, as the JAX generator
threads it (generator.py:137, :218).

``spk_emb_mode="learned"`` (JAX generator.py:72-111) adds a
``speaker_encoder`` (``models.encoders.SpeakerEncoder``, built after the
other submodules so a one-hot model's keys and seeded weights stay as
they were): ``embed_speaker(mel)`` gives the timbre code of any
utterance, and a rank-3 ``c_trg`` (a mel [B, T, 80]) goes through it
inside the forward.

``config.compute_dtype`` (float32 or bfloat16) is every layer's
``dtype``. With bfloat16 the multi-stream call takes W_hh in bfloat16
for the encoders' streams of H >= 2 and in float32 for the H=1 rhythm
stream, in one launch, its xp float32 (the JAX ``streams`` mode).
"""


from __future__ import annotations

import torch
from torch import nn

from speechsplit_tpu_torch.config import SpeechSplitConfig, resolve_dtype
from speechsplit_tpu_torch.models.decoders import F0Decoder, MelDecoder
from speechsplit_tpu_torch.models.encoders import (
    ContentPitchEncoder,
    F0Encoder,
    RhythmEncoder,
    SpeakerEncoder,
)
from speechsplit_tpu_torch.models.layers import combine_bidir, upsample_codes
from speechsplit_tpu_torch.ops import multi_bilstm


def _model_dtype(config: SpeechSplitConfig) -> torch.dtype:
    """``config.compute_dtype``, float32 or bfloat16, the dtype every
    layer is built at (JAX builds its modules at it, train_step.py:77);
    the parameters stay float32 either way."""
    return resolve_dtype(config.compute_dtype)


def _generator(generator):
    return generator if generator is not None else torch.Generator()


class SpeechSplit(nn.Module):
    """Triple-information-bottleneck generator.

    Inputs (``[B, T, .]``): ``x_f0`` mel ++ one-hot F0 [B, T, 80+257],
    ``x_org`` un-augmented mel [B, T, 80], ``c_trg`` speaker embedding
    [B, 82], or in learned mode a mel [B, T', 80] to embed. Returns the
    converted mel [B, T, 80]. T must be a multiple
    of every ``freq`` so the code streams line up; in train mode T must
    be ``max_len_pad``, the length the resampling pads to.
    """

    def __init__(self, config: SpeechSplitConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        if config.spk_emb_mode not in ("onehot", "learned"):
            raise ValueError(f"spk_emb_mode must be 'onehot' or 'learned', "
                             f"got {config.spk_emb_mode!r}")
        gen = _generator(generator)
        dtype = _model_dtype(config)
        self.config = config
        self.encoder_1 = ContentPitchEncoder(config, gen, dtype)
        self.encoder_2 = RhythmEncoder(config, gen, dtype)
        self.decoder = MelDecoder(config, gen, dtype)
        if config.spk_emb_mode == "learned":
            self.speaker_encoder = SpeakerEncoder(config, gen, dtype)

    def embed_speaker(self, mel: torch.Tensor) -> torch.Tensor:
        """An utterance's mel [B, T, 80] (zero past its length) -> its
        unit-norm speaker embedding [B, dim_spk_emb] (learned mode)."""
        if self.config.spk_emb_mode != "learned":
            raise ValueError("embed_speaker needs spk_emb_mode='learned'")
        return self.speaker_encoder(mel)

    def forward(self, x_f0: torch.Tensor, x_org: torch.Tensor,
                c_trg: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                example_ids: torch.Tensor | None = None,
                global_batch: int | None = None) -> torch.Tensor:
        cfg = self.config
        if c_trg.dim() == 3:
            # a mel to take the timbre from (training passes the batch's
            # own mel, conversion the target's utterance)
            if cfg.spk_emb_mode != "learned":
                raise ValueError(
                    "mel-valued c_trg requires spk_emb_mode='learned'")
            c_trg = self.speaker_encoder(c_trg)
        enc_cp, enc_r = self.encoder_1, self.encoder_2
        xc, xp = enc_cp.pre(x_f0, train=train, generator=generator,
                            example_ids=example_ids,
                            global_batch=global_batch)
        xr = enc_r.pre(x_org)
        if not multi_bilstm.fits((cfg.dim_neck, cfg.dim_neck_3,
                                  cfg.dim_neck_2)):
            # each encoder's own layers (JAX generator.py:150-154)
            codes_content, codes_pitch = enc_cp.codes(enc_cp.lstm_1(xc),
                                                      enc_cp.lstm_2(xp))
            codes_rhythm = enc_r.codes(enc_r.lstm(xr))
        else:
            s_c = enc_cp.lstm_1(xc, mode="streams", start_layer=0)
            s_p = enc_cp.lstm_2(xp, mode="streams")
            s_r = enc_r.lstm(xr, mode="streams")
            outs = multi_bilstm.multi_bilstm_sequence(
                3,
                s_c[0], s_c[1], s_p[0], s_p[1], s_r[0], s_r[1],
                s_c[2], s_c[3], s_p[2], s_p[3], s_r[2], s_r[3],
                residual_dtype=resolve_dtype(cfg.residual_dtype),
            )
            h_content = enc_cp.lstm_1(combine_bidir(outs[0], outs[1]),
                                      start_layer=1)
            codes_content, codes_pitch = enc_cp.codes(
                h_content, combine_bidir(outs[2], outs[3])
            )
            codes_rhythm = enc_r.codes(combine_bidir(outs[4], outs[5]))

        content = upsample_codes(codes_content, cfg.freq)
        pitch = upsample_codes(codes_pitch, cfg.freq_3)
        rhythm = upsample_codes(codes_rhythm, cfg.freq_2)
        batch, t = x_f0.shape[0], x_f0.shape[1]
        spk = c_trg[:, None, :].expand(batch, t, c_trg.shape[-1])
        decoder_in = torch.cat([content, rhythm, pitch, spk], dim=-1)
        return self.decoder(decoder_in)

    def rhythm(self, x_org: torch.Tensor) -> torch.Tensor:
        """Rhythm-code extraction endpoint (ref: model.py:316-320)."""
        return self.encoder_2(x_org)


class F0Converter(nn.Module):
    """F0-contour converter: rhythm codes of the source mel + pitch codes
    of the target one-hot contour -> 257-bin logits [B, T, dim_f0]."""

    def __init__(self, config: SpeechSplitConfig,
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = _generator(generator)
        dtype = _model_dtype(config)
        self.config = config
        self.encoder_2 = RhythmEncoder(config, gen, dtype)
        self.encoder_3 = F0Encoder(config, gen, dtype)
        self.decoder = F0Decoder(config, gen, dtype)

    def forward(self, x_org: torch.Tensor, f0_trg: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None,
                example_ids: torch.Tensor | None = None,
                global_batch: int | None = None) -> torch.Tensor:
        cfg = self.config
        enc_f, enc_r = self.encoder_3, self.encoder_2
        xf = enc_f.pre(f0_trg, train=train, generator=generator,
                       example_ids=example_ids, global_batch=global_batch)
        xr = enc_r.pre(x_org)
        if not multi_bilstm.fits((cfg.dim_neck_3, cfg.dim_neck_2)):
            # each encoder's own layer (JAX generator.py:228-232)
            codes_f0 = enc_f.codes(enc_f.lstm(xf))
            codes_rhythm = enc_r.codes(enc_r.lstm(xr))
        else:
            s_f = enc_f.lstm(xf, mode="streams")
            s_r = enc_r.lstm(xr, mode="streams")
            outs = multi_bilstm.multi_bilstm_sequence(
                2, s_f[0], s_f[1], s_r[0], s_r[1], s_f[2], s_f[3], s_r[2],
                s_r[3], residual_dtype=resolve_dtype(cfg.residual_dtype),
            )
            codes_f0 = enc_f.codes(combine_bidir(outs[0], outs[1]))
            codes_rhythm = enc_r.codes(combine_bidir(outs[2], outs[3]))
        rhythm = upsample_codes(codes_rhythm, cfg.freq_2)
        pitch = upsample_codes(codes_f0, cfg.freq_3)
        return self.decoder(torch.cat([rhythm, pitch], dim=-1))
