"""Synthetic speech-like corpora with synthesis-derived ground truth
(counterpart of speechsplit_tpu/data/synthetic.py; numpy and scipy on the
host, the same draws and the same bytes).

Classic impulse-excited formant synthesis: a jittered glottal
(differentiated Rosenberg) pulse train driven through a cascade of
second-order formant resonators, plus fricative noise and silence
segments. Two jobs:

1. **Pitch-tracker validation**: the per-period instantaneous F0 of the
   pulse train is ground truth produced by the *synthesis* process
   itself, with no pitch tracker in the loop.
2. **Corpus generation** (:func:`make_corpus`): multi-speaker wav trees
   for vocoder training, data-path rehearsals and benchmarks. The
   reference repo ships a mini VCTK subset for "code verification
   purpose only" (README.md:49-50); these corpora fill the same role with
   unlimited size.

Ground-truth conventions match the tracker contract
(ops/pitch.py::track_pitch): one frame per ``hop`` samples, frame t
anchored at sample ``t*hop``.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
from scipy import signal as sp_signal

FS = 16000
HOP = 256

# (frequency Hz, bandwidth Hz) — neutral-vowel-ish formants
FORMANTS = ((500.0, 80.0), (1500.0, 100.0), (2500.0, 140.0))

# a handful of vowel-like formant sets for corpus diversity (F1/F2/F3)
VOWEL_FORMANTS: Sequence[Tuple[Tuple[float, float], ...]] = (
    FORMANTS,
    ((300.0, 60.0), (2200.0, 120.0), (2900.0, 150.0)),   # /i/-ish
    ((700.0, 90.0), (1100.0, 110.0), (2500.0, 140.0)),   # /a/-ish
    ((350.0, 70.0), (800.0, 90.0), (2400.0, 140.0)),     # /u/-ish
    ((550.0, 80.0), (1700.0, 110.0), (2600.0, 140.0)),   # /e/-ish
)


def _formant_filter(
    x: np.ndarray,
    fs: int = FS,
    formants: Sequence[Tuple[float, float]] = FORMANTS,
) -> np.ndarray:
    """Cascade of 2nd-order resonators (all-pole formant synthesis)."""
    y = x.astype(np.float64)
    for f, bw in formants:
        r = np.exp(-np.pi * bw / fs)
        theta = 2 * np.pi * f / fs
        a = [1.0, -2.0 * r * np.cos(theta), r * r]
        y = sp_signal.lfilter([1.0 - r], a, y)
    return y


def _rosenberg_pulse(period: int) -> np.ndarray:
    """Differentiated Rosenberg glottal pulse of one period's length."""
    n_open = max(2, int(0.4 * period))
    n_close = max(1, int(0.16 * period))
    t_o = np.arange(n_open) / n_open
    opening = 0.5 * (1.0 - np.cos(np.pi * t_o))
    t_c = np.arange(n_close) / n_close
    closing = np.cos(0.5 * np.pi * t_c)
    g = np.concatenate(
        [opening, closing, np.zeros(max(0, period - n_open - n_close))]
    )
    return np.diff(g, prepend=0.0)


class Stimulus:
    def __init__(self, n_samples: int):
        self.wav = np.zeros(n_samples, np.float64)
        # instantaneous F0 per sample (0 where unvoiced/silent)
        self.f0_per_sample = np.zeros(n_samples, np.float64)
        # True where the sample belongs to a voiced segment
        self.voiced_per_sample = np.zeros(n_samples, bool)
        # True in a margin zone around segment transitions (excluded
        # from scoring: every tracker smears decisions near boundaries)
        self.transition = np.zeros(n_samples, bool)

    def frame_ground_truth(
        self, hop: int = HOP, margin_frames: int = 3
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-frame (f0, voiced, scoreable) at the tracker's frame grid.

        Frame t is labeled from the samples its correlation window spans
        (``t*hop .. t*hop+window``); a frame is scoreable only when that
        whole span is uniformly voiced or uniformly unvoiced and clear of
        transition margins.
        """
        n = len(self.wav)
        n_frames = n // hop + 1
        window = 120  # must cover PitchParams.window
        f0 = np.zeros(n_frames)
        voiced = np.zeros(n_frames, bool)
        scoreable = np.zeros(n_frames, bool)
        for t in range(n_frames):
            a = t * hop
            b = min(a + window, n)
            if b <= a:
                continue
            seg_v = self.voiced_per_sample[a:b]
            seg_t = self.transition[a:b]
            if seg_t.any():
                continue
            if seg_v.all():
                vals = self.f0_per_sample[a:b]
                vals = vals[vals > 0]
                if len(vals) == 0:
                    continue
                f0[t] = np.median(vals)
                voiced[t] = True
                scoreable[t] = True
            elif (~seg_v).all():
                scoreable[t] = True
        # tracker edge frames (analysis window off the end) never score
        scoreable[: margin_frames] = False
        scoreable[-(margin_frames + 2):] = False
        return f0, voiced, scoreable


def synth_utterance(
    seed: int,
    segments: List[Tuple[str, float, Callable[[np.ndarray], np.ndarray]]],
    fs: int = FS,
    jitter_pct: float = 1.0,
    shimmer_db: float = 1.0,
    snr_db: float = 20.0,
    formants: Optional[Sequence[Tuple[float, float]]] = None,
) -> Stimulus:
    """Synthesize an utterance from (kind, duration_s, contour) segments.

    kind: 'voiced' (contour maps segment-relative time [0,1] -> F0 Hz),
    'fricative' (high-passed noise), or 'silence'.
    """
    rng = np.random.RandomState(seed)
    n_total = int(sum(d for _, d, _ in segments) * fs)
    stim = Stimulus(n_total)
    excitation = np.zeros(n_total)

    pos = 0
    for kind, dur, contour in segments:
        seg_len = int(dur * fs)
        a, b = pos, min(pos + seg_len, n_total)
        if kind == "voiced":
            p = a
            while p < b:
                rel = (p - a) / seg_len
                f_target = float(contour(np.asarray(rel)))
                f_actual = f_target * (
                    1.0 + jitter_pct / 100.0 * rng.randn()
                )
                f_actual = np.clip(f_actual, 40.0, 620.0)
                period = max(8, int(round(fs / f_actual)))
                amp = 10.0 ** (
                    shimmer_db * rng.randn() / 20.0
                )
                pulse = _rosenberg_pulse(period) * amp
                end = min(p + period, b)
                excitation[p:end] += pulse[: end - p]
                stim.f0_per_sample[p:end] = fs / period
                stim.voiced_per_sample[p:end] = True
                p += period
        elif kind == "fricative":
            noise = rng.randn(b - a)
            sos = sp_signal.butter(4, 3500, "highpass", fs=fs, output="sos")
            excitation[a:b] += 0.12 * sp_signal.sosfilt(sos, noise)
        elif kind == "silence":
            pass
        else:
            raise ValueError(kind)
        # mark transition margins (±12 ms) around segment boundaries
        m = int(0.012 * fs)
        stim.transition[max(0, a - m): min(n_total, a + m)] = True
        stim.transition[max(0, b - m): min(n_total, b + m)] = True
        pos += seg_len

    voiced_speech = _formant_filter(
        excitation, fs, formants if formants is not None else FORMANTS
    )
    # aspiration noise on voiced parts + floor noise everywhere (SNR)
    sig_rms = np.sqrt(np.mean(voiced_speech**2) + 1e-12)
    noise = rng.randn(n_total) * sig_rms * 10.0 ** (-snr_db / 20.0)
    wav = voiced_speech + noise
    stim.wav = (wav / (np.abs(wav).max() + 1e-9) * 0.6).astype(np.float32)
    return stim


def default_utterance(seed: int, base_f0: float) -> Stimulus:
    """A sentence-like utterance: two voiced runs with natural contours
    separated by a fricative and closed by silence."""
    decline = lambda r: base_f0 * (1.25 - 0.35 * r)
    rise_fall = lambda r: base_f0 * (0.95 + 0.25 * np.sin(np.pi * r))
    return synth_utterance(
        seed,
        [
            ("voiced", 0.55, decline),
            ("fricative", 0.22, None),
            ("voiced", 0.65, rise_fall),
            ("silence", 0.18, None),
            ("voiced", 0.45, decline),
        ],
    )


# -------------------------------------------------------------- corpora


def random_utterance(
    seed: int,
    base_f0: float,
    duration_s: float = 2.2,
    formants: Optional[Sequence[Tuple[float, float]]] = None,
) -> Stimulus:
    """A randomized sentence-like utterance for corpus generation:
    voiced runs with random contour shapes interleaved with fricatives
    and pauses, totalling ~``duration_s`` seconds."""
    rng = np.random.RandomState((seed * 7919 + 13) % (2**32 - 1))
    segments: list = []
    total = 0.0
    while total < duration_s:
        kind = rng.choice(
            ["voiced", "fricative", "silence"], p=[0.62, 0.22, 0.16]
        )
        if kind == "voiced":
            dur = float(rng.uniform(0.25, 0.7))
            shape = rng.randint(0, 3)
            a = float(rng.uniform(0.85, 1.25))
            b = float(rng.uniform(-0.35, 0.35))
            c = float(rng.uniform(0.1, 0.4))
            if shape == 0:  # declination
                contour = lambda r, a=a, b=b: base_f0 * (a + b * r)
            elif shape == 1:  # rise-fall
                contour = lambda r, a=a, c=c: base_f0 * (
                    a + c * np.sin(np.pi * r)
                )
            else:  # wobble
                contour = lambda r, a=a, c=c: base_f0 * (
                    a + 0.5 * c * np.sin(3.1 * np.pi * r)
                )
            segments.append(("voiced", dur, contour))
        else:
            dur = float(rng.uniform(0.08, 0.25))
            segments.append((kind, dur, None))
        total += dur
    return synth_utterance(
        seed,
        segments,
        jitter_pct=float(rng.uniform(0.5, 1.5)),
        shimmer_db=float(rng.uniform(0.5, 1.5)),
        snr_db=float(rng.uniform(18.0, 30.0)),
        formants=formants,
    )


def speaker_formant_sets(
    n_speakers: int, rng: np.random.RandomState
) -> List[Tuple[Tuple[float, float], ...]]:
    """Draw a UNIQUE formant set per speaker (timbre ground truth).

    Each speaker gets its own (F1, F2, F3) resonator cascade, jittered
    from the vowel prototypes with per-speaker vocal-tract-length-like
    scaling — so "timbre" is a constant, known property of each
    synthetic speaker and timbre-conversion quality can be scored
    against ground truth (QUALITY.md). Keeps F1 < F2 < F3 separated so
    every set is a plausible vocal tract.
    """
    sets = []
    for s in range(n_speakers):
        proto = VOWEL_FORMANTS[s % len(VOWEL_FORMANTS)]
        # vocal-tract-length factor + independent per-formant jitter
        vtl = float(rng.uniform(0.88, 1.15))
        fs_ = []
        prev = 0.0
        for f, bw in proto:
            f2 = f * vtl * float(rng.uniform(0.92, 1.08))
            f2 = max(f2, prev + 250.0)
            fs_.append((float(f2), float(bw * rng.uniform(0.9, 1.2))))
            prev = f2
        sets.append(tuple(fs_))
    return sets


def make_corpus(
    out_dir: str,
    n_utterances: int,
    n_speakers: int = 8,
    seed: int = 0,
    duration_s: float = 2.2,
    progress_every: int = 0,
    distinct_formants: bool = False,
) -> List[str]:
    """Write a multi-speaker wav corpus ``out_dir/p<300+s>/u<i>.wav``.

    Speakers alternate male-ish/female-ish base F0 (drawn per speaker
    from 95-135 / 175-235 Hz) and rotate through VOWEL_FORMANTS, so the
    corpus spans the gender-dependent pitch ranges the preprocessing
    pipeline handles (make_spect_f0.py:40-45). Returns the wav paths in
    the deterministic ``data.prepare.list_wavs`` order.

    ``distinct_formants=True`` draws a unique formant set per speaker
    (:func:`speaker_formant_sets`) and writes the per-speaker ground
    truth (base F0, formants) to ``out_dir/_speakers.json`` — the
    disentanglement-evaluation corpus mode (QUALITY.md): pitch identity
    = base F0, timbre identity = formant set, rhythm/content = the
    per-utterance segment structure.
    """
    import json

    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    bases = []
    for s in range(n_speakers):
        if s % 2 == 0:
            bases.append(float(rng.uniform(95.0, 135.0)))
        else:
            bases.append(float(rng.uniform(175.0, 235.0)))
    if distinct_formants:
        formant_sets = speaker_formant_sets(n_speakers, rng)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "_speakers.json"), "w") as fh:
            json.dump(
                {
                    f"p{300 + s}": {
                        "base_f0": bases[s],
                        "formants": [list(f) for f in formant_sets[s]],
                    }
                    for s in range(n_speakers)
                },
                fh,
                indent=1,
            )
    else:
        formant_sets = [
            VOWEL_FORMANTS[s % len(VOWEL_FORMANTS)]
            for s in range(n_speakers)
        ]
    paths = []
    for i in range(n_utterances):
        s = i % n_speakers
        speaker_dir = os.path.join(out_dir, f"p{300 + s}")
        os.makedirs(speaker_dir, exist_ok=True)
        stim = random_utterance(
            (seed * 1_000_003 + i) % (2**31 - 1),
            bases[s],
            duration_s=duration_s,
            formants=formant_sets[s],
        )
        path = os.path.join(speaker_dir, f"u{i:05d}.wav")
        wavfile.write(
            path, FS, (stim.wav * 32767.0).astype(np.int16)
        )
        paths.append(path)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"corpus: {i + 1}/{n_utterances}", flush=True)
    from speechsplit_tpu_torch.data.prepare import list_wavs

    return list_wavs(out_dir)
