"""Separation metrics: SI-SNR(i) and SDR(i) (the port's copy of
``mindaudio_tpu.metric.snr``, pinned to it by
``tests/test_torch_separation_recipe.py``). NumPy and SciPy on the host.

SDR is BSS Eval v3's ``bss_eval_sources`` (Vincent, Gribonval & Fevotte
2006; the algorithm mir_eval implements): the estimate is decomposed against
the span of 512-tap delayed versions of all reference sources by a
least-squares FIR projection (block-Toeplitz normal equations solved from
FFT cross- and auto-correlations), giving s_target / e_interf / e_artif and
SDR/SIR/SAR with best-permutation matching, so that SDRi is on the scale of
published Conv-TasNet results.
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = ["bss_eval_sources", "cal_SISNR", "cal_SISNRi", "cal_SDRi"]


def _project(reference_sources, estimated_source, flen):
    """Least-squares projection of ``estimated_source`` onto the subspace
    spanned by all ``flen``-sample delayed versions of every reference
    source (BSS Eval v3's multichannel time-invariant filter projection).

    ``reference_sources``: (C, T); returns the projection, length
    ``T + flen - 1`` (the full filtered support).
    """
    from scipy.linalg import toeplitz
    from scipy.signal import fftconvolve

    nsrc, nsampl = reference_sources.shape
    refs = np.hstack((reference_sources, np.zeros((nsrc, flen - 1))))
    est = np.hstack((estimated_source, np.zeros(flen - 1)))

    n_fft = int(2 ** np.ceil(np.log2(nsampl + flen - 1.0)))
    sf = np.fft.fft(refs, n=n_fft, axis=1)
    sef = np.fft.fft(est, n=n_fft)

    # normal equations G c = d: G holds inner products between delayed
    # reference sources (block Toeplitz from circular correlations), d the
    # inner products between the estimate and the delayed references
    g = np.zeros((nsrc * flen, nsrc * flen))
    for i in range(nsrc):
        for j in range(i, nsrc):
            ssf = np.real(np.fft.ifft(sf[i] * np.conj(sf[j])))
            block = toeplitz(np.hstack((ssf[0], ssf[-1:-flen:-1])),
                             r=ssf[:flen])
            g[i * flen:(i + 1) * flen, j * flen:(j + 1) * flen] = block
            if i != j:
                g[j * flen:(j + 1) * flen, i * flen:(i + 1) * flen] = block.T

    d = np.zeros(nsrc * flen)
    for i in range(nsrc):
        ssef = np.real(np.fft.ifft(sf[i] * np.conj(sef)))
        d[i * flen:(i + 1) * flen] = np.hstack((ssef[0], ssef[-1:-flen:-1]))

    try:
        c = np.linalg.solve(g, d).reshape(flen, nsrc, order="F")
    except np.linalg.LinAlgError:
        c = np.linalg.lstsq(g, d, rcond=None)[0].reshape(flen, nsrc, order="F")

    sproj = np.zeros(nsampl + flen - 1)
    for i in range(nsrc):
        sproj += fftconvolve(c[:, i], refs[i])[: nsampl + flen - 1]
    return sproj


def _bss_decomp_mtifilt(reference_sources, estimated_source, j, flen):
    """Decompose ``estimated_source`` into s_target + e_interf + e_artif
    relative to reference source ``j`` (single-channel case: no e_spat)."""
    nsampl = estimated_source.size
    s_target = np.hstack((reference_sources[j], np.zeros(flen - 1)))
    # projection onto delays of the true source alone
    e_spat = _project(reference_sources[j][None, :], estimated_source,
                      flen) - s_target
    # extra energy explained by the OTHER sources' delay span = interference
    e_interf = _project(reference_sources, estimated_source, flen) \
        - s_target - e_spat
    e_artif = -s_target - e_spat - e_interf
    e_artif[:nsampl] += estimated_source
    return s_target, e_spat, e_interf, e_artif


def _bss_source_crit(s_target, e_spat, e_interf, e_artif, eps=0.0):
    def db(num, den):
        return 10 * np.log10(num / den) if den > 0 else np.inf

    s_filt = s_target + e_spat
    sdr = db(np.sum(s_filt**2), np.sum((e_interf + e_artif) ** 2))
    sir = db(np.sum(s_filt**2), np.sum(e_interf**2))
    sar = db(np.sum((s_filt + e_interf) ** 2), np.sum(e_artif**2))
    return sdr, sir, sar


def bss_eval_sources(reference_sources, estimated_sources,
                     compute_permutation=True, filter_length=512):
    """BSS Eval v3 ``bss_eval_sources``: returns ``(sdr, sir, sar, perm)``
    arrays of length C, the permutation chosen to maximize mean SIR (the
    semantics of the routine the reference imports from mir_eval,
    reference metric/snr.py:2,16).
    """
    reference_sources = np.atleast_2d(np.asarray(reference_sources, float))
    estimated_sources = np.atleast_2d(np.asarray(estimated_sources, float))
    nsrc = reference_sources.shape[0]
    assert estimated_sources.shape == reference_sources.shape

    if compute_permutation:
        sdr_all = np.empty((nsrc, nsrc))
        sir_all = np.empty((nsrc, nsrc))
        sar_all = np.empty((nsrc, nsrc))
        for jest in range(nsrc):
            for jtrue in range(nsrc):
                parts = _bss_decomp_mtifilt(
                    reference_sources, estimated_sources[jest], jtrue,
                    filter_length)
                (sdr_all[jest, jtrue], sir_all[jest, jtrue],
                 sar_all[jest, jtrue]) = _bss_source_crit(*parts)
        best_perm, best_sir = None, -np.inf
        for perm in itertools.permutations(range(nsrc)):
            mean_sir = np.mean([sir_all[perm[j], j] for j in range(nsrc)])
            if mean_sir > best_sir:
                best_sir, best_perm = mean_sir, perm
        idx = np.asarray(best_perm)
        dum = np.arange(nsrc)
        return (sdr_all[idx, dum], sir_all[idx, dum], sar_all[idx, dum], idx)

    sdr = np.empty(nsrc)
    sir = np.empty(nsrc)
    sar = np.empty(nsrc)
    for j in range(nsrc):
        parts = _bss_decomp_mtifilt(reference_sources, estimated_sources[j],
                                    j, filter_length)
        sdr[j], sir[j], sar[j] = _bss_source_crit(*parts)
    return sdr, sir, sar, np.arange(nsrc)


def cal_SISNR(ref_sig, out_sig, eps=1e-8):
    """SI-SNR in dB between two 1-D signals (zero-mean projected)."""
    assert len(ref_sig) == len(out_sig)
    ref_sig = ref_sig - np.mean(ref_sig)
    out_sig = out_sig - np.mean(out_sig)
    proj = np.sum(ref_sig * out_sig) * ref_sig / (np.sum(ref_sig**2) + eps)
    noise = out_sig - proj
    return 10 * np.log10(np.sum(proj**2) / (np.sum(noise**2) + eps) + eps)


def cal_SISNRi(src_ref, src_est, mix):
    """SI-SNR improvement: mean over sources of best-permutation SI-SNR minus
    the mixture baseline. ``src_ref``/``src_est``: (C, T); ``mix``: (T,)."""
    c = src_ref.shape[0]
    best = -np.inf
    for perm in itertools.permutations(range(c)):
        snr = np.mean([cal_SISNR(src_ref[i], src_est[perm[i]]) for i in range(c)])
        best = max(best, snr)
    base = np.mean([cal_SISNR(src_ref[i], mix) for i in range(c)])
    return best - base, best


def cal_SDRi(src_ref, src_est, mix):
    """bss_eval SDR improvement over the mixture anchor (reference
    metric/snr.py:5-20: ``bss_eval_sources`` on the estimates and on
    ``[mix] * C``, SDRi = mean per-source difference).

    Returns ``(avg_SDRi, avg_SDR)`` — improvement plus the absolute SDR.
    """
    src_ref = np.asarray(src_ref, float)
    c = src_ref.shape[0]
    src_anchor = np.stack([np.asarray(mix, float)] * c, axis=0)
    sdr, _, _, _ = bss_eval_sources(src_ref, np.asarray(src_est, float))
    sdr0, _, _, _ = bss_eval_sources(src_ref, src_anchor)
    return float(np.mean(sdr - sdr0)), float(np.mean(sdr))
