"""Surrogate null models of the port, batched along a surrogate axis.

Two generators, both (keys (..., 2), series (..., L), n) -> (..., n, L):

  * random_shuffle  — i.i.d. permutations: preserves the amplitude
    distribution only (destroys all temporal structure).
  * phase_randomized — FFT phase randomization: preserves the power
    spectrum (the full linear autocorrelation) while destroying
    nonlinear structure.  The standard CCM null.

The draws are the JAX package's, bit for bit (``inference/prng.py``):
a shuffle surrogate equals the JAX one exactly; a phase surrogate agrees
within the rounding of the FFT (``torch.fft`` — cuFFT on the card —
rounds otherwise than ``jnp.fft``).

:func:`surrogate_futures` is the batched entry the significance pipeline
consumes: per-target keys are derived by ``fold_in`` on the GLOBAL
series id, so the null draw for a pair is independent of chunk geometry
and reproducible from the single run seed.
"""
from __future__ import annotations

import torch

from repro_torch.core import embedding
from repro_torch.inference import prng


def random_shuffle(key: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., L) -> (..., n, L) independent random permutations of x."""
    keys = prng.split(key, n)
    return prng.permutation(keys, x[..., None, :].expand(keys.shape[:-1] + x.shape[-1:]))


def phase_randomized(key: torch.Tensor, x: torch.Tensor, n: int) -> torch.Tensor:
    """(..., L) -> (..., n, L) FFT phase-randomized surrogates of x.

    Magnitudes of the rfft are kept and the phases of the
    strictly-positive-frequency bins replaced by uniform draws in
    [0, 2 pi); the DC bin — and, for even L, the Nyquist bin — keep their
    original complex value so the inverse transform stays real with the
    same mean and alternating component."""
    L = x.shape[-1]
    X = torch.fft.rfft(x)
    nf = X.shape[-1]
    keep = torch.zeros(nf, dtype=torch.bool, device=x.device)
    keep[0] = True
    if L % 2 == 0:
        keep[nf - 1] = True
    phases = prng.uniform(prng.split(key, n), (nf,), 0.0, prng.TWO_PI_F32)
    Xs = torch.where(
        keep, X[..., None, :], X.abs()[..., None, :] * torch.exp(1j * phases)
    )
    return torch.fft.irfft(Xs, n=L).to(x.dtype)


_GENERATORS = {"shuffle": random_shuffle, "phase": phase_randomized}


def surrogate_futures(
    key: torch.Tensor,
    ts_rows: torch.Tensor,
    series_ids,
    n: int,
    kind: str,
    cfg,
) -> torch.Tensor:
    """Null-model target futures for a set of series.

    ts_rows (t, L) raw target series; series_ids (t,) their GLOBAL ids
    (the fold_in salt).  Returns (t * n, Lp) future-value rows — target
    0's n surrogates first, then target 1's, ... — the layout of a
    bucket-sorted column tile whose every segment count is scaled by n,
    so the batch streams through the same lookup as the real targets."""
    gen = _GENERATORS[kind]
    Lp = cfg.n_points(ts_rows.shape[-1])
    ids = torch.as_tensor(series_ids, device=key.device)
    surr = gen(prng.fold_in(key, ids), ts_rows, n)  # (t, n, L)
    fut = embedding.future_values(surr, cfg.E_max, cfg.tau, cfg.Tp, Lp)
    return fut.reshape(-1, Lp)
