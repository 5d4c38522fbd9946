"""Device engine: Li-Stephens leave-one-out copy-model likelihood.

The reference's copyLogLikelihoodDropOne (pbwtLikelihood.c:380-420) is an
explicit O(NM^2) dense recurrence - its slowest algorithm.  On the device
the per-site update is one elementwise pass over the (M, M) copy matrix
plus a row sum, which XLA fuses, driven by a lax.scan over sites:

  left <- (left * (1-rho) + rho/(M-1)) * (theta if x_i != x_j else 1-theta)
  left[i][i] <- 0 ;  LL_i += log(sum_j left[i][j]) ;  left[i] /= sum_j

The allele-agreement matrix is rank-1 (outer compare of the site column),
so only the column vector is carried into the step.  The previous step's
normalisation is folded into the next update (left is carried
un-normalised together with its inverse row sums), so each site is a
single pass over the matrix.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def copy_ll_device(X: np.ndarray, theta: float, rho: float) -> float:
    """Device Li-Stephens drop-one log likelihood; equals the host
    copy_log_likelihood_drop_one up to f32 accumulation order."""
    M, N = X.shape
    rho1, rho_m = 1.0 - rho, rho / (M - 1.0)
    theta1 = 1.0 - theta

    @jax.jit
    def run(cols):
        off_diag = ~jnp.eye(M, dtype=bool)

        def body(carry, x):
            left, invrs, ll = carry
            eq = x[:, None] == x[None, :]
            upd = (left * (rho1 * invrs) + rho_m) * jnp.where(eq, theta1,
                                                             theta)
            upd = jnp.where(off_diag, upd, 0.0)
            rs = jnp.maximum(jnp.sum(upd, axis=1, keepdims=True), 1e-30)
            return (upd, 1.0 / rs, ll + jnp.log(rs[:, 0])), None

        left0 = jnp.where(off_diag, jnp.float32(1.0 / (M - 1.0)), 0.0)
        init = (left0, jnp.ones((M, 1), jnp.float32),
                jnp.zeros(M, jnp.float32))
        (_, _, ll), _ = jax.lax.scan(body, init, cols)
        return ll

    ll = run(jnp.asarray(np.ascontiguousarray(X.T, np.uint8)))
    return float(np.asarray(ll).sum())
