"""The 30 Hz Butterworth high-pass's design (counterpart of
speechsplit_tpu/ops/filters.py; reference utils.py:10-14,
make_spect_f0.py:17,54).

The production path applies the filter's |H(w)|^2 on the STFT bins
(``preprocess._stft_bin_gain``), so only the coefficients are ported,
designed on the host with scipy as in JAX. The waveform high-pass
(``zero_phase_highpass``, ``extract_features(highpass_mode="time")``)
and the sample-by-sample scan oracles (``sosfilt``, ``lfilter``,
``filtfilt``, ``sosfiltfilt``, ``highpass_filtfilt``) wait in
ROADMAP.md A6.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import signal as sp_signal


def butter_highpass(cutoff: float, fs: float,
                    order: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Design a Butterworth high-pass, (b, a) form (ref: utils.py:10-14)."""
    nyq = 0.5 * fs
    b, a = sp_signal.butter(order, cutoff / nyq, btype="high", analog=False)
    return b.astype(np.float64), a.astype(np.float64)
