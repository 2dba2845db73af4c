"""Host-side xoroshiro128** RNG.

The reference uses the xoroshiro128** family on the host for camera-ray
anti-alias jitter and to derive independent per-replica seeds via jump()
(ref: include/xoshiro.hpp, src/IpuScene.cpp:648-654). We provide the same
capability: a small, fast, jumpable generator implemented from the public
xoroshiro128** algorithm (Blackman & Vigna, public domain), vectorised with
numpy where useful.

Device-side RNG uses ``jax.random`` (threefry) / ops/rng.py instead —
distribution-level parity only, exactly as the reference accepts between
its CPU and IPU renderers (RNG streams differ; images match in
distribution, see LITERATE_TEST.ipynb methodology).
"""

import numpy as np

_MASK = (1 << 64) - 1


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _MASK


def _splitmix64_next(state: int):
    state = (state + 0x9E3779B97F4A7C15) & _MASK
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return state, z ^ (z >> 31)


class Xoroshiro128:
    """xoroshiro128** seeded via splitmix64, with jump() for parallel streams."""

    def __init__(self, seed: int):
        sm = seed & _MASK
        sm, s0 = _splitmix64_next(sm)
        sm, s1 = _splitmix64_next(sm)
        self._s = [s0, s1]

    def next_u64(self) -> int:
        s0, s1 = self._s
        result = (_rotl((s0 * 5) & _MASK, 7) * 9) & _MASK
        s1 ^= s0
        self._s[0] = _rotl(s0, 24) ^ s1 ^ ((s1 << 16) & _MASK)
        self._s[1] = _rotl(s1, 37)
        return result

    def jump(self) -> None:
        """Advance 2^64 steps: yields a non-overlapping parallel stream."""
        JUMP = (0xDF900294D8F554A5, 0x170865DF4B3201FC)
        s0 = 0
        s1 = 0
        for j in JUMP:
            for b in range(64):
                if j & (1 << b):
                    s0 ^= self._s[0]
                    s1 ^= self._s[1]
                self.next_u64()
        self._s = [s0, s1]

    def uniform_0_1(self, n: int | None = None):
        """Uniform float32 samples in [0, 1)."""
        if n is None:
            return np.float32((self.next_u64() >> 40) * (1.0 / (1 << 24)))
        vals = np.empty(n, dtype=np.float32)
        for i in range(n):
            vals[i] = (self.next_u64() >> 40) * (1.0 / (1 << 24))
        return vals

    def normal(self, n: int, sigma: float = 1.0) -> np.ndarray:
        """Gaussian samples via Box-Muller over uniform_0_1 pairs."""
        m = (n + 1) // 2
        u1 = np.maximum(self.uniform_0_1(m), np.float32(1e-12))
        u2 = self.uniform_0_1(m)
        r = np.sqrt(-2.0 * np.log(u1)).astype(np.float32)
        th = np.float32(2.0 * np.pi) * u2
        out = np.concatenate([r * np.cos(th), r * np.sin(th)])[:n]
        return (out * np.float32(sigma)).astype(np.float32)


def derive_replica_seeds(seed: int, num_replicas: int) -> np.ndarray:
    """Independent u64 seeds, one per data-parallel replica (jump-separated)."""
    g = Xoroshiro128(seed)
    seeds = np.empty(num_replicas, dtype=np.uint64)
    for i in range(num_replicas):
        seeds[i] = np.uint64(g.next_u64())
        g.jump()
    return seeds
