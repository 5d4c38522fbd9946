import numpy as np

from pbwt_tpu.algos.likelihood import copy_log_likelihood_drop_one
from pbwt_tpu.core.pbwt import PBWT


def test_device_ll_matches_host():
    from pbwt_tpu.ops.likelihood_jax import copy_ll_device
    rng = np.random.RandomState(3)
    X = (rng.random_sample((36, 50)) < 0.4).astype(np.uint8)
    host = copy_log_likelihood_drop_one(PBWT.from_haplotypes(X), 0.08, 0.03)
    dev = copy_ll_device(X, 0.08, 0.03)
    assert abs(host - dev) / abs(host) < 1e-5


def test_device_ll_small_M():
    from pbwt_tpu.ops.likelihood_jax import copy_ll_device
    rng = np.random.RandomState(4)
    X = (rng.random_sample((13, 30)) < 0.4).astype(np.uint8)
    host = copy_log_likelihood_drop_one(PBWT.from_haplotypes(X), 0.1, 0.05)
    dev = copy_ll_device(X, 0.1, 0.05)
    assert abs(host - dev) / abs(host) < 1e-5
