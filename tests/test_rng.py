"""Statistical tests for the counter-based RNG (ops/rng.py).

The reference leans on the IPU's hardware RNG whose contract is
"independent uniforms per worker"; these tests pin the same contract for
the hash generator: uniformity (moments + chi-square), independence
across the (path, bounce, dim) counter axes, Box-Muller normality, and
bit balance. Methodology follows the reference's distribution-parity
approach (LITERATE_TEST histogram cells) with 4-sigma acceptance bands.
"""

import numpy as np

import jax.numpy as jnp

from ipu_ray_lib_tpu.ops.rng import hash_u32, normal2, uniform01

N = 1 << 20


def _u(pids, bounce=7, dim=0):
    return np.asarray(
        uniform01(jnp.asarray(pids, jnp.uint32), jnp.uint32(bounce),
                  jnp.uint32(dim))
    )


def test_uniform_moments():
    u = _u(np.arange(N))
    se_mean = 4.0 / np.sqrt(12 * N)          # 4 sigma
    assert abs(u.mean() - 0.5) < se_mean
    assert abs(u.var() - 1.0 / 12.0) < 4.0 * (1.0 / 12.0) / np.sqrt(N) * 2
    assert u.min() >= 0.0 and u.max() < 1.0


def test_uniform_chi_square():
    u = _u(np.arange(N))
    bins = 256
    counts, _ = np.histogram(u, bins=bins, range=(0.0, 1.0))
    expected = N / bins
    chi2 = ((counts - expected) ** 2 / expected).sum()
    # dof = 255: mean 255, sd ~22.6; accept within ~5 sigma:
    assert chi2 < 255 + 5 * np.sqrt(2 * 255), chi2


def test_stream_independence():
    """Correlations across counter axes: same pid different dim, same pid
    consecutive bounce, consecutive pids."""
    pids = np.arange(N)
    u0 = _u(pids, dim=0)
    u1 = _u(pids, dim=1)
    ub = _u(pids, bounce=8, dim=0)
    thresh = 4.0 / np.sqrt(N)
    assert abs(np.corrcoef(u0, u1)[0, 1]) < thresh
    assert abs(np.corrcoef(u0, ub)[0, 1]) < thresh
    assert abs(np.corrcoef(u0[:-1], u0[1:])[0, 1]) < thresh


def test_bit_balance():
    bits = np.asarray(hash_u32(jnp.arange(N, dtype=jnp.uint32)))
    for b in range(32):
        frac = ((bits >> np.uint32(b)) & 1).mean()
        assert abs(frac - 0.5) < 4.0 / (2 * np.sqrt(N)), (b, frac)


def test_box_muller_normality():
    g1, g2 = normal2(jnp.arange(N, dtype=jnp.uint32), jnp.uint32(3))
    for g in (np.asarray(g1), np.asarray(g2)):
        assert abs(g.mean()) < 4.0 / np.sqrt(N)
        assert abs(g.var() - 1.0) < 4.0 * np.sqrt(2.0 / N)
        skew = (g ** 3).mean()
        kurt = (g ** 4).mean()
        assert abs(skew) < 4.0 * np.sqrt(15.0 / N)
        assert abs(kurt - 3.0) < 4.0 * np.sqrt(96.0 / N)
        # Tail quantiles vs the normal distribution:
        q = np.quantile(g, [0.025, 0.975])
        assert abs(q[0] + 1.9600) < 0.02
        assert abs(q[1] - 1.9600) < 0.02
