"""Counter-based per-lane RNG for the streaming wavefront.

The reference leans on the IPU's hardware RNG (`__builtin_ipu_urand`),
whose contract is simply "independent uniforms per worker, cheap".
The equivalent here is a stateless counter-based generator: a few
rounds of integer mixing over (stream, counter, dim) produce uniforms
vectorised over lanes with no key bookkeeping. Like the reference's
CPU-vs-IPU situation, different renderers agree in distribution, not
stream-for-stream (LITERATE_TEST methodology).

Mixing: two rounds of a 32-bit xxhash/murmur-style avalanche over the
inputs — passes the moment checks in tests/test_rng.py.
"""

from __future__ import annotations

import jax.numpy as jnp

_M1 = jnp.uint32(0x85EBCA6B)
_M2 = jnp.uint32(0xC2B2AE35)
_M3 = jnp.uint32(0x27D4EB2F)
_GOLDEN = jnp.uint32(0x9E3779B9)


def _mix(h: jnp.ndarray) -> jnp.ndarray:
    h = h ^ (h >> 16)
    h = h * _M1
    h = h ^ (h >> 13)
    h = h * _M2
    h = h ^ (h >> 16)
    return h


def hash_u32(*streams) -> jnp.ndarray:
    """Combine integer streams (broadcastable) into mixed uint32s."""
    h = jnp.uint32(0x811C9DC5)
    for s in streams:
        h = _mix(h ^ (jnp.asarray(s).astype(jnp.uint32) * _M3 + _GOLDEN))
    return _mix(h)


def uniform01(*streams) -> jnp.ndarray:
    """Uniform float32 in [0, 1): 24 mantissa-worth bits of hash."""
    bits = hash_u32(*streams)
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def normal2(*streams):
    """A pair of standard gaussians per lane (Box-Muller over two hashes)."""
    u1 = jnp.maximum(uniform01(*streams, jnp.uint32(0xA5)), jnp.float32(1e-12))
    u2 = uniform01(*streams, jnp.uint32(0x5A))
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    th = jnp.float32(2.0 * 3.14159265358979) * u2
    return r * jnp.cos(th), r * jnp.sin(th)
