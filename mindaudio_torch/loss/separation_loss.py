"""SI-SNR and the permutation-invariant training loss for source separation
(port of ``mindaudio_tpu.loss.separation_loss``).

SI-SNR is scale invariant: both signals are made zero-mean over their valid
samples, the estimate is projected on the target, and the ratio of the
projection's energy to the residual's is taken in dB. PIT scores every
permutation of the C estimates against the C targets and keeps the best
one, whatever C is.

The SI-SNR of an (estimate, target) pair does not depend on the other
pairs, so the C x C pairs are computed once and each of the C!
permutations is a gather of C of them: the values are those of the JAX
package, which computes every permutation's pairs anew, and each mean over
the C sources adds them in the same order.
"""

from __future__ import annotations

import itertools

import torch

__all__ = ["cal_si_snr", "pit_si_snr_loss"]


def cal_si_snr(est, target, lengths=None, eps=1e-8):
    """Scale-invariant SNR in dB, ``(..., T)`` estimates and targets (they
    broadcast) → ``(...)``; the JAX package's ``cal_si_snr_jax``.

    ``lengths`` is an optional ``(B,)`` of valid sample counts, ``B`` the
    first axis: samples past it enter no statistic. The JAX function takes
    ``(B, C, T)``; any shape whose first axis is the batch works here.
    """
    if lengths is not None:
        view = (-1,) + (1,) * (est.dim() - 1)
        lengths = lengths.reshape(view)
        mask = (torch.arange(est.shape[-1], device=est.device) < lengths).to(est.dtype)
        n = torch.clamp_min(lengths.to(est.dtype), 1.0)
    else:
        mask = torch.ones((), dtype=est.dtype, device=est.device)
        n = est.shape[-1]
    est, target = est * mask, target * mask
    est = (est - est.sum(-1, keepdim=True) / n) * mask
    target = (target - target.sum(-1, keepdim=True) / n) * mask

    dot = (est * target).sum(-1, keepdim=True)
    t_energy = (target ** 2).sum(-1, keepdim=True) + eps
    proj = dot * target / t_energy
    noise = est - proj
    ratio = (proj ** 2).sum(-1) / ((noise ** 2).sum(-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


def pit_si_snr_loss(est, target, lengths=None):
    """Permutation-invariant negative SI-SNR of ``(B, C, T)`` estimates
    against ``(B, C, T)`` targets.

    Returns ``(loss, best_perm)``: the batch mean of the best permutation's
    negative SI-SNR (its gradient flows through that permutation alone)
    and the ``(B, C)`` int64 permutation, ``best_perm[b, i]`` the target
    paired with estimate ``i``. Ties go to the first permutation in
    ``itertools.permutations`` order, as ``jnp.argmax`` gives them.
    """
    c = est.shape[1]
    perms = torch.tensor(list(itertools.permutations(range(c))), device=est.device)  # (P, C)
    # pairs[b, i, j]: estimate i against target j
    pairs = cal_si_snr(est[:, :, None, :], target[:, None, :, :], lengths)
    all_snr = pairs[:, torch.arange(c, device=est.device), perms].mean(-1)  # (B, P)
    best = all_snr.argmax(-1)
    max_snr = all_snr.gather(1, best[:, None])[:, 0]
    return -max_snr.mean(), perms[best]
