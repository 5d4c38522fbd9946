"""Seeded synthetic panels for the benchmark and the on-chip smoke test.

Sites draw their alternate-allele frequency from Beta(0.2, 0.8), a skewed
spectrum with many rare variants; queries are mosaics of panel rows, so
they carry real long matches.  Nothing is downloaded: every array comes
from a seed.
"""

from __future__ import annotations

import numpy as np


def beta_panel(M: int, N: int, rng: np.random.RandomState) -> np.ndarray:
    """(M, N) uint8 haplotypes with per-site Beta(0.2, 0.8) frequencies.

    Generated in row blocks: MT19937 draws sequentially, so this yields
    the same bytes as one (M, N) draw without materialising the (M, N)
    float64 intermediate."""
    freqs = rng.beta(0.2, 0.8, size=N)
    X = np.empty((M, N), np.uint8)
    B = max(1, (1 << 24) // max(N, 1))
    for r0 in range(0, M, B):
        r1 = min(r0 + B, M)
        X[r0:r1] = rng.random_sample((r1 - r0, N)) < freqs[None, :]
    return X


def match_data(M: int, N: int, Qmax: int, seed: int = 0):
    """Panel + Qmax mosaic queries (segments of 50-399 sites copied from
    random panel rows) for the matchDynamic workloads."""
    rng = np.random.RandomState(seed)
    Xp = beta_panel(M, N, rng)
    Xq = np.empty((Qmax, N), np.uint8)
    for q in range(Qmax):
        pos = 0
        while pos < N:
            seg = rng.randint(50, 400)
            src = rng.randint(0, M)
            Xq[q, pos:pos + seg] = Xp[src, pos:pos + seg]
            pos += seg
    return Xp, Xq
