"""Host-side waveform and spectrogram augmentation (the port's copy of
``mindaudio_tpu.data.augment``: ``convolve1d``, ``reverberate``,
``rms_normalize``, ``caculate_rms``, ``add_noise``, ``add_reverb``,
``drop_freq``, ``speed_perturb`` and ``drop_chunk``, pinned to the originals
bit for bit by ``tests/test_torch_ecapa_recipe.py``; ``frequencymasking``,
``timemasking``, ``add_babble``, ``time_stretch`` and ``pitch_shift`` by
``tests/test_torch_data_copies.py``).

NumPy on the host, as in the JAX package, so that one
``np.random.Generator`` gives the same batches in both: the ECAPA-TDNN
recipe's collate runs them in the prefetch thread while the card runs the
step before. Every stochastic function takes an optional ``rng``; without
one it draws from a fresh ``np.random.default_rng()``.
"""

from __future__ import annotations

import numpy as np

from .filters import notch_filter
from .io import read
from .processing import resample, rescale
from .spectrum import compute_amplitude, dB_to_amplitude, istft, stft

__all__ = [
    "frequencymasking",
    "timemasking",
    "convolve1d",
    "reverberate",
    "rms_normalize",
    "caculate_rms",
    "add_noise",
    "add_reverb",
    "drop_freq",
    "speed_perturb",
    "drop_chunk",
    "add_babble",
    "time_stretch",
    "pitch_shift",
]


def convolve1d(
    waveforms,
    kernel,
    padding=0,
    pad_type="constant",
    stride=1,
    groups=1,
    use_fft=True,
    rotation_index=0,
):
    """1-D convolution of ``(batch, time, channel)``-style signals.

    FFT path multiplies spectra after rotating the kernel by ``rotation_index``
    (circular convolution aligned to the RIR direct path); the direct path uses
    ``np.convolve`` in 'valid' mode. Accepts 1-D/2-D/3-D inputs like the
    reference (augment.py:177), which always convolves with a single kernel.

    Deliberate divergence: integer ``padding`` pads symmetrically. The
    reference honors only tuple padding (augment.py:232 checks
    ``isinstance(padding, tuple)``) although its own ``drop_freq`` passes an
    int (augment.py:592-596), so there the notch filter's 50-sample group
    delay goes uncompensated and the head of the signal wraps circularly —
    an inherited upstream bug, not intended behavior; with the pad honored,
    drop_freq is a proper 'same' convolution with no time shift.
    """
    waveforms = np.asarray(waveforms)
    kernel = np.asarray(kernel)
    n_dim = waveforms.ndim
    if n_dim == 1:
        waveforms = waveforms[None, :, None]
    elif n_dim == 2:
        waveforms = waveforms[..., None]
    if kernel.ndim == 1:
        kernel = kernel[None, :, None]
    elif kernel.ndim == 2:
        kernel = kernel[..., None]

    waveforms = np.transpose(waveforms, (0, 2, 1))  # (batch, channel, time)
    kernel = np.transpose(kernel, (0, 2, 1))

    unpadded_len = waveforms.shape[-1]
    if isinstance(padding, int) and padding > 0:
        padding = (padding, padding)
    if isinstance(padding, tuple):
        waveforms = np.pad(
            waveforms, [(0, 0), (0, 0), (padding[0], padding[-1])], mode=pad_type
        )

    if use_fft:
        zero_length = waveforms.shape[-1] - kernel.shape[-1]
        if zero_length < 0:
            kernel = kernel[..., :zero_length]
            zero_length = 0
        zeros = np.zeros((kernel.shape[0], kernel.shape[1], zero_length))
        kernel = np.concatenate(
            (kernel[..., rotation_index:], zeros, kernel[..., :rotation_index]), axis=-1
        )
        # scipy.fft keeps float32 signals in complex64 (np.fft always promotes
        # to complex128 — measured 2.3x slower on recipe-sized augment batches,
        # where this convolution IS the collate bottleneck); the kernel is
        # cast to the signal dtype so a float64 filter design doesn't drag the
        # whole transform back up — float signals only: casting |coef| < 1
        # filters to an integer waveform dtype would truncate them to zero
        from scipy import fft as _sfft

        if np.issubdtype(waveforms.dtype, np.floating):
            kernel = kernel.astype(waveforms.dtype, copy=False)
        convolved = _sfft.irfft(
            _sfft.rfft(waveforms) * _sfft.rfft(kernel), n=waveforms.shape[-1]
        )
        if isinstance(padding, tuple) and padding[0] + padding[-1] > 0 and rotation_index == 0:
            # symmetric/explicit pad with an unrotated kernel: the linear
            # 'same' output lives at offset left_pad + right_pad (no circular
            # wrap reaches it) — crop back to the input length
            off = padding[0] + padding[-1]
            convolved = convolved[..., off : off + unpadded_len]
    else:
        # the reference path is nn.Conv1d = cross-correlation; np.convolve
        # flips its kernel internally, so pass the pre-flipped kernel once
        k = kernel.reshape(-1)[::-1]
        flat = waveforms.reshape(-1, waveforms.shape[-1])
        rows = [np.convolve(row, k, mode="valid")[::stride] for row in flat]
        convolved = np.stack(rows).reshape(waveforms.shape[:-1] + (-1,))

    if n_dim == 1:
        return convolved[0, 0]
    if n_dim == 2:
        return convolved[:, 0]
    return np.transpose(convolved, (0, 2, 1))


def reverberate(waveforms, rir_waveform, rescale_amp="avg"):
    """Convolve with a Room Impulse Response, preserving alignment and level.

    The RIR is rotated so its direct path (argmax) lands at lag zero, the FFT
    circular convolution is applied, and the result is rescaled to the original
    amplitude. Parity: reference augment.py:101.
    """
    waveforms = np.asarray(waveforms)
    rir_waveform = np.asarray(rir_waveform)
    orig_shape = waveforms.shape
    if waveforms.ndim > 3 or rir_waveform.ndim > 3:
        raise NotImplementedError

    if waveforms.ndim == 1:
        waveforms = waveforms[None, :, None]
    elif waveforms.ndim == 2:
        waveforms = waveforms[..., None]
    if rir_waveform.ndim == 1:
        rir_waveform = rir_waveform[None, :, None]
    elif rir_waveform.ndim == 2:
        rir_waveform = rir_waveform[..., None]

    orig_amplitude = compute_amplitude(waveforms, waveforms.shape[1], rescale_amp)
    direct_index = int(np.argmax(np.abs(rir_waveform)))

    waveforms = convolve1d(
        waveforms=waveforms,
        kernel=rir_waveform,
        use_fft=True,
        rotation_index=direct_index,
    )

    if len(orig_shape) == 1:
        waveforms = waveforms[0, :, 0]
        lengths = len(waveforms)
        target = float(np.squeeze(orig_amplitude))
    elif len(orig_shape) == 2:
        waveforms = waveforms[..., 0]
        lengths = waveforms.shape[1]
        target = orig_amplitude[..., 0]
    else:
        lengths = waveforms.shape[1]
        target = orig_amplitude

    return rescale(waveforms, target, lengths=lengths, amp_type=rescale_amp)


def rms_normalize(samples):
    """Scale to unit RMS over the whole array (reference augment.py:282)."""
    rms = np.sqrt(np.square(samples).mean(keepdims=True))
    return samples / (rms + 1e-8)


def caculate_rms(samples):
    """RMS along the last axis (reference augment.py:296)."""
    return np.sqrt(np.square(samples).mean(axis=-1, keepdims=False))


def add_noise(samples, backgroundlist, min_snr_in_db, max_snr_in_db, mix_prob=1.0, rng=None):
    """Mix randomly-chosen background files into the batch at a sampled SNR.

    Background clips are concatenated (RMS-normalized) until they cover the
    signal length, scaled to the target SNR against each item's RMS, and added.
    Parity: reference augment.py:310.
    """
    rng = np.random.default_rng() if rng is None else rng
    samples = np.asarray(samples)
    if rng.random() > mix_prob:
        return samples

    n_dim = samples.ndim
    if n_dim > 3:
        raise NotImplementedError
    if n_dim == 1:
        samples = samples[None, None, :]
    elif n_dim == 2:
        samples = samples[:, None, :]
    _, _, sample_length = samples.shape

    missing = sample_length
    pieces = []
    while missing > 0:
        path = backgroundlist[int(rng.integers(0, len(backgroundlist)))]
        noise_audio, _ = read(path)
        if noise_audio.ndim > 1:
            noise_audio = noise_audio.mean(axis=-1)
        if len(noise_audio) == 0:
            raise ValueError(f"background file {path!r} decoded to 0 samples"
                             " (a silent skip here would loop forever)")
        if len(noise_audio) > missing:
            pieces.append(rms_normalize(noise_audio[:missing]))
            missing = 0
        else:
            pieces.append(rms_normalize(noise_audio))
            missing -= len(noise_audio)
    background = rms_normalize(np.concatenate(pieces).reshape(1, sample_length))

    sample_rms = caculate_rms(samples)
    snr = rng.uniform(min_snr_in_db, max_snr_in_db, 1)
    background_scale = sample_rms / (10 ** (snr / 20))
    noisy = samples + background[None] * background_scale[..., None]

    if n_dim == 1:
        return noisy[0, 0]
    if n_dim == 2:
        return noisy[:, 0]
    return noisy


def add_reverb(samples, rirlist, reverb_prob=1.0, rng=None):
    """Reverberate with a randomly-chosen RIR file (reference augment.py:383)."""
    rng = np.random.default_rng() if rng is None else rng
    samples = np.asarray(samples)
    if rng.random() > reverb_prob:
        return samples

    orig_ndim = samples.ndim
    if orig_ndim > 3:
        raise NotImplementedError
    if orig_ndim == 2:
        x = samples[..., None]
    elif orig_ndim == 3:
        batch, channel, times = samples.shape
        x = samples.reshape(batch * channel, times)[..., None]
    else:
        x = samples

    rir_path = rirlist[int(rng.integers(0, len(rirlist)))]
    rir_waveform, _ = read(rir_path)
    res = reverberate(x, rir_waveform)

    if orig_ndim == 3:
        return res[..., 0].reshape(batch, channel, times)
    if orig_ndim == 2:
        return res[..., 0]
    return np.asarray(res)[0] if np.asarray(res).ndim > 1 else res


def drop_freq(
    waveforms,
    drop_freq_low=1e-14,
    drop_freq_high=1,
    drop_count_low=1,
    drop_count_high=2,
    drop_width=0.05,
    drop_prob=1,
    rng=None,
):
    """Notch out 1-2 random frequency bands (reference augment.py:512)."""
    rng = np.random.default_rng() if rng is None else rng
    waveforms = np.asarray(waveforms)
    orig_ndim = waveforms.ndim
    dropped = waveforms.copy()
    if rng.random() > drop_prob:
        return dropped

    if orig_ndim == 1:
        dropped = dropped[None, :, None]
    elif orig_ndim == 2:
        dropped = dropped[..., None]

    n_drops = int(rng.integers(drop_count_low, drop_count_high + 1))
    freqs = drop_freq_low + rng.random(n_drops) * (drop_freq_high - drop_freq_low)

    # compose all notch kernels into ONE 101-tap filter (convolution is
    # associative; 'same' truncation keeps each stage centered), then apply
    # it to the signal in a single pass
    filter_length = 101
    pad = filter_length // 2
    kernel = np.zeros(filter_length)
    kernel[pad] = 1.0
    for f in freqs:
        kernel = np.convolve(
            kernel, notch_filter(f, filter_length, drop_width)[0, :, 0],
            mode="same")

    dropped = convolve1d(dropped, kernel[None, :, None], pad)

    if orig_ndim == 2:
        return dropped[..., 0]
    if orig_ndim == 1:
        return dropped[0, :, 0] if dropped.ndim == 3 else dropped
    return dropped


def speed_perturb(waveform, orig_freq, speeds=(90, 100, 110), perturb_prob=1.0, rng=None):
    """Resample to a randomly-chosen percentage of the original rate.

    Parity: reference augment.py:601.
    """
    rng = np.random.default_rng() if rng is None else rng
    waveform = np.asarray(waveform)
    if rng.random() > perturb_prob:
        return waveform.copy()
    speed = speeds[int(rng.integers(0, len(speeds)))]
    new_freq = orig_freq * speed // 100
    return resample(waveform, orig_freq, new_freq)


def drop_chunk(
    waveforms,
    lengths,
    drop_length_low=100,
    drop_length_high=1000,
    drop_count_low=1,
    drop_count_high=10,
    drop_start=0,
    drop_end=None,
    drop_prob=1,
    noise_factor=0.0,
    rng=None,
):
    """Zero (or noise-fill) random spans of each signal (reference augment.py:641).

    Fully vectorized: every span's (count, length, start) is sampled up-front
    as ``(batch, max_count)`` arrays and the drop regions become ONE boolean
    mask built by broadcasting time indices against the span bounds — no
    per-utterance or per-span Python loops.
    """
    if drop_length_low > drop_length_high:
        raise ValueError("Low limit must not be more than high limit")
    if drop_count_low > drop_count_high:
        raise ValueError("Low limit must not be more than high limit")
    if drop_end is not None and drop_end >= 0:
        if drop_start > drop_end:
            raise ValueError("Low limit must not be more than high limit")
        span = drop_end - drop_start
        drop_length_low = min(drop_length_low, span)
        drop_length_high = min(drop_length_high, span)

    rng = np.random.default_rng() if rng is None else rng
    waveforms = np.asarray(waveforms)
    dropped = waveforms.copy()
    if rng.random() > drop_prob:
        return dropped

    batch, t_max = waveforms.shape[:2]
    lengths = np.asarray(lengths) * t_max
    n_drops = rng.integers(drop_count_low, drop_count_high + 1, size=batch)
    max_drops = int(n_drops.max(initial=0))
    if max_drops == 0:
        return dropped

    span_len = rng.integers(drop_length_low, drop_length_high + 1,
                            size=(batch, max_drops))
    # per-element start window [lo, hi]: negative start/end count from each
    # element's unpadded length; hi leaves room for the element's longest span
    lo = drop_start + lengths if drop_start < 0 else np.full(batch, drop_start, float)
    hi = (lengths if drop_end is None
          else drop_end + lengths if drop_end < 0
          else np.full(batch, drop_end, float))
    hi = np.maximum(0.0, hi - span_len.max(axis=1))
    # floor of uniform [lo, hi+1) == integer uniform on [lo, hi] inclusive
    start = np.floor(
        lo[:, None] + rng.random((batch, max_drops)) * (hi + 1 - lo)[:, None]
    ).astype(np.int64)
    end = start + span_len

    t_idx = np.arange(t_max)
    mask = np.zeros((batch, t_max), bool)
    for j in range(max_drops):  # bounded by drop_count_high, not batch/time
        mask |= ((j < n_drops)[:, None]
                 & (t_idx >= start[:, j : j + 1]) & (t_idx < end[:, j : j + 1]))

    if noise_factor:
        clean_amplitude = compute_amplitude(waveforms, lengths[:, None])
        peak = 2 * clean_amplitude * noise_factor  # (B, 1) or (B, 1, C)
        noise = (2.0 * rng.random(waveforms.shape) - 1.0) * peak
        fill = noise
    else:
        fill = np.zeros((), waveforms.dtype)
    if waveforms.ndim == 3:
        mask = mask[:, :, None]
    return np.where(mask, fill, dropped)


def _mask_along_axis(spec, mask_param, mask_start, mask_value, axis, iid_masks, rng):
    """Shared SpecAugment masking (torchaudio Frequency/TimeMasking semantics).

    ``axis``: -2 = frequency, -1 = time, on input shaped ``(..., freq, time)``.
    With ``iid_masks`` a different mask is drawn per batch element; otherwise
    one random-width mask at a random start (``mask_start`` is only honored in
    the iid branch, like msaudio).
    """
    rng = np.random.default_rng() if rng is None else rng
    spec = np.array(spec, copy=True)
    if mask_param == 0:
        return spec
    axis_len = spec.shape[axis]

    def apply_one(block):
        width = int(rng.integers(0, mask_param + 1))
        if iid_masks:
            start = int(mask_start)
        else:
            start = int(rng.integers(0, max(axis_len - width, 0) + 1))
        if width == 0:
            return block
        sl = [slice(None)] * block.ndim
        sl[axis] = slice(start, start + width)
        block[tuple(sl)] = mask_value
        return block

    if iid_masks and spec.ndim > 2:
        for i in range(spec.shape[0]):
            spec[i] = apply_one(spec[i])
        return spec
    return apply_one(spec)


def frequencymasking(
    waveform, iid_masks=False, frequency_mask_param=0, mask_start=0, mask_value=0.0, rng=None
):
    """Mask a random band of frequency bins in a spectrogram ``(..., freq, time)``.

    Parity: reference augment.py:28 (msaudio.FrequencyMasking).
    """
    return _mask_along_axis(
        waveform, frequency_mask_param, mask_start, mask_value, -2, iid_masks, rng
    )


def timemasking(
    waveform, iid_masks=False, frequency_mask_param=0, mask_start=0, mask_value=0.0, rng=None
):
    """Mask a random band of time frames in a spectrogram ``(..., freq, time)``.

    Parity: reference augment.py:65 (msaudio.TimeMasking).
    """
    return _mask_along_axis(
        waveform, frequency_mask_param, mask_start, mask_value, -1, iid_masks, rng
    )


def add_babble(waveforms, lengths, speaker_count=3, snr_low=0, snr_high=0, mix_prob=1.0, rng=None):
    """Simulate babble by mixing rolled copies of the batch into each signal.

    Parity: reference augment.py:433.
    """
    rng = np.random.default_rng() if rng is None else rng
    waveforms = np.asarray(waveforms)
    if rng.random() > mix_prob:
        return waveforms.copy()

    batch = len(waveforms)
    lengths = (np.asarray(lengths) * waveforms.shape[1]).reshape(batch, 1)

    clean_amplitude = compute_amplitude(waveforms, lengths)
    snr = rng.random((batch, 1)) * (snr_high - snr_low) + snr_low
    noise_gain = 1.0 / (dB_to_amplitude(snr, 1, 1) + 1.0)

    # item b babbles with items b-1 .. b-speaker_count (cyclic): one
    # fancy-indexed gather instead of a roll-accumulate loop. The effective
    # babble length is the max over the contributing items' lengths.
    src = (np.arange(batch)[None, :]
           - np.arange(1, speaker_count + 1)[:, None]) % batch
    babble = waveforms[src].sum(axis=0)
    babble_len = lengths[src].max(axis=0)
    babble = babble * (noise_gain * clean_amplitude
                       / (compute_amplitude(babble, babble_len) + 1e-14))
    out = (1.0 - noise_gain) * waveforms + babble
    return out.astype(waveforms.dtype, copy=False)


def time_stretch(waveforms, rate=None):
    """Phase-vocoder time stretch by ``rate`` without changing pitch.

    Parity: reference augment.py:795.
    """
    if rate is None or rate <= 0:
        raise ValueError("rate must be a positive number")
    spec = stft(waveforms)
    spec_stretch = _phase_vocoder(spec, rate=rate)
    length_stretch = int(round(np.asarray(waveforms).shape[-1] / rate))
    return istft(spec_stretch, length=length_stretch)


def _phase_vocoder(matrix, rate, hop_length=None, n_fft=None):
    """Vectorized Ellis phase vocoder over an STFT matrix ``(..., freq, time)``.

    One gather + one cumulative sum replace the reference's per-output-frame
    Python loop (reference augment.py:828-890): magnitudes are linearly
    interpolated between the two bracketing input frames; each bin's phase
    advance is unwrapped against its expected per-hop advance and the output
    phase is the running (exclusive) sum of those advances along the
    stretched time axis. The accumulation runs in float64 — the loop form
    kept its accumulator in the float32 the first ``np.angle`` returned, so
    its phase drifted ~1e-4 rad/frame once the unwrapped phase grew large.
    """
    matrix = np.asarray(matrix)
    if n_fft is None:
        n_fft = 2 * (matrix.shape[-2] - 1)
    hop = int(n_fft // 4) if hop_length is None else hop_length

    # fractional input positions of the stretched output frames
    pos = np.arange(0, matrix.shape[-1], rate, dtype=np.float64)
    lo = pos.astype(np.int64)
    frac = pos - lo

    padded = np.pad(matrix, [(0, 0)] * (matrix.ndim - 1) + [(0, 2)])
    # transcendentals once over the padded matrix, in its native f32
    # precision (the f64 cumsum below is where accuracy actually matters);
    # the per-output-frame gathers are then cheap indexing
    mag_all = np.abs(padded)
    ang_all = np.angle(padded)

    f = frac.astype(mag_all.dtype)
    mag = (1.0 - f) * mag_all[..., lo] + f * mag_all[..., lo + 1]

    omega = np.linspace(0, np.pi * hop, matrix.shape[-2])[:, None]
    delta = (ang_all[..., lo + 1] - ang_all[..., lo]) - omega
    delta -= 2.0 * np.pi * np.round(delta / (2.0 * np.pi))  # wrap to ±pi
    advance = omega + delta
    phase = (np.cumsum(advance, axis=-1) - advance) + ang_all[..., :1]
    phase = phase.astype(mag.dtype)
    # assemble through the real/imag views: `mag * (cos + 1j*sin)` would
    # promote everything to complex128 (the `1j` literal is a Python complex)
    out = np.empty(phase.shape, dtype=matrix.dtype)
    out.real = mag * np.cos(phase)
    out.imag = mag * np.sin(phase)
    return out


def pitch_shift(waveforms, sr, n_steps, bins_per_octave=12):
    """Shift pitch by ``n_steps`` (stretch then resample, reference augment.py:874)."""
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    stretched = time_stretch(waveforms, rate=rate)
    shifted = resample(stretched, orig_freq=float(sr) / rate, new_freq=sr)
    target = stretched.shape[-1]
    if shifted.shape[-1] > target:
        return shifted[..., :target]
    if shifted.shape[-1] < target:
        pad = [(0, 0)] * shifted.ndim
        pad[-1] = (0, target - shifted.shape[-1])
        return np.pad(shifted, pad)
    return shifted

