"""The path kernel's counter-based hash RNG: the draws a Pallas kernel
makes equal the XLA-side oracle (`hash_uniform` / `hash_tapes`), they lie
in the open unit interval, and the stream is keyed by the global sample
index."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from drt_tpu.ops import pathkernel

N = 64


def _kernel_draws(seed, s, b, dim):
    """Draws for pixels 0..N-1 made inside a Triton-route Pallas kernel
    (interpreted) with the kernel's own hash code path."""

    def kernel(seed_ref, out_ref):
        pix = lax.broadcasted_iota(jnp.int32, (N,), 0)
        bits = pathkernel._hash_bits(pathkernel._u32(seed_ref[0]),
                                     pathkernel._u32(pix),
                                     pathkernel._u32(seed_ref[1]),
                                     pathkernel._u32(seed_ref[2]), dim)
        out_ref[...] = pathkernel._bits_to_open_unit(bits, np.float32)

    args = jnp.asarray([seed, s, b], jnp.int32)
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((N,), jnp.float32),
        backend="triton", interpret=True)(args)


@pytest.mark.parametrize("dim", [0, 1, 2])
@pytest.mark.parametrize("seed,s,b", [(0, 0, 0), (12345, 7, 3),
                                      (-5, 255, 31), (2**31 - 1, 1, 4)])
def test_in_kernel_draws_equal_hash_uniform(seed, s, b, dim):
    got = np.asarray(_kernel_draws(seed, s, b, dim))
    want = np.asarray(pathkernel.hash_uniform(
        seed, jnp.arange(N, dtype=jnp.int32), s, b, dim, jnp.float32))
    np.testing.assert_array_equal(got, want)


def test_hash_uniform_open_interval_and_spread():
    n = 1 << 14
    i = jnp.arange(n, dtype=jnp.int32)
    u = np.asarray(pathkernel.hash_uniform(7, i, i // 64, i % 5, 1,
                                           jnp.float32))
    assert (u > 0.0).all() and (u < 1.0).all()
    hist, _ = np.histogram(u, bins=16, range=(0.0, 1.0))
    sigma = np.sqrt(n * (1 / 16) * (15 / 16))
    assert np.abs(hist - n / 16).max() < 5 * sigma


@pytest.mark.parametrize("split", [1, 2, 3])
def test_hash_tapes_keyed_by_global_sample(split):
    """Tapes of spp samples equal the concatenation of tapes drawn in two
    pieces with sample_base offsets (rays are spp-outer)."""
    seeds = jnp.asarray([3, 9], jnp.int32)
    npix, spp, depth = 10, 4, 3
    cam, tape = pathkernel.hash_tapes(seeds, npix, spp, depth, jnp.float32)
    cam_a, tape_a = pathkernel.hash_tapes(seeds, npix, split, depth,
                                          jnp.float32)
    cam_b, tape_b = pathkernel.hash_tapes(seeds, npix, spp - split, depth,
                                          jnp.float32, sample_base=split)
    np.testing.assert_array_equal(np.asarray(cam),
                                  np.concatenate([cam_a, cam_b], -1))
    np.testing.assert_array_equal(np.asarray(tape),
                                  np.concatenate([tape_a, tape_b], -1))


def test_streams_are_distinct():
    """Camera and bounce streams, dims and bounces draw different bits."""
    pix = jnp.arange(256, dtype=jnp.int32)
    draws = [np.asarray(pathkernel.hash_uniform(seed, pix, 0, b, dim,
                                                jnp.float32))
             for seed in (1, 2) for b in (0, 1) for dim in (0, 1, 2)]
    for i in range(len(draws)):
        for j in range(i + 1, len(draws)):
            assert not np.array_equal(draws[i], draws[j])
