"""Port vs JAX package: coding/rans.py's per-lane twins, encode_reverse_scan
and decode_step, on the inputs of the JAX package's own tests of them
(tests/test_coding.py::test_decode_step_matches_scalar and
::test_device_encoder_matches_cpp)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from imgcomp_cvpr_tpu.coding import rans as jrans
from imgcomp_cvpr_tpu_torch.coding import rans as trans


def _random_tables(rng, n, L=6):
    """The JAX tests' tables: Dirichlet probabilities through JAX's
    quantize_cdf."""
    probs = rng.dirichlet(np.ones(L) * 0.5, size=n).astype(np.float32)
    freq, cdf_low = jax.device_get(jrans.quantize_cdf(jnp.asarray(probs)))
    return freq.astype(np.uint32), cdf_low.astype(np.uint32)


def _encoder_inputs():
    """test_device_encoder_matches_cpp's (T, M) = (50, 7) tables."""
    rng = np.random.RandomState(21)
    T, M = 50, 7
    freq = np.zeros((T, M), np.uint32)
    start = np.zeros((T, M), np.uint32)
    active = rng.rand(T, M) < 0.75
    for j in range(M):
        n = active[:, j].sum()
        f, c = _random_tables(rng, n)
        s = np.array([rng.choice(6, p=ff / ff.sum()) for ff in f])
        freq[active[:, j], j] = f[np.arange(n), s]
        start[active[:, j], j] = c[np.arange(n), s]
    return freq, start, active


def test_encode_reverse_scan_byte_equal_to_jax_and_encode_reverse():
    freq, start, active = _encoder_inputs()
    jbuf, jcounts, jstates = jax.device_get(jrans.encode_reverse_scan(
        jnp.asarray(freq), jnp.asarray(start), jnp.asarray(active)))
    buf, counts, states = trans.encode_reverse_scan(
        torch.from_numpy(freq.astype(np.int64)), torch.from_numpy(start.astype(np.int64)),
        torch.from_numpy(active))
    np.testing.assert_array_equal(buf.numpy().astype(np.uint32), np.asarray(jbuf))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(states.numpy().astype(np.uint32), np.asarray(jstates))
    # And the port's own per-lane encoder, numpy loop and native runtime.
    for native in (False, True):
        streams, st_ref, k = trans.encode_reverse(freq, start, active, native=native)
        np.testing.assert_array_equal(states.numpy().astype(np.uint32), st_ref)
        for j in range(freq.shape[1]):
            np.testing.assert_array_equal(buf[j, :counts[j]].numpy()[::-1], streams[j])


def test_decode_step_byte_equal_to_jax_and_scalar():
    rng = np.random.RandomState(3)
    n = 64
    freq, cdf_low = _random_tables(rng, n)
    syms = np.array([rng.choice(6, p=f / f.sum()) for f in freq])
    words, state, _ = trans.scalar_encode(syms, freq, cdf_low)
    streams = np.zeros((1, n), np.uint32)
    streams[0, :len(words)] = words
    j_st, j_ptr = jnp.asarray([state], jnp.uint32), jnp.zeros((1,), jnp.int32)
    t_st, t_ptr = torch.tensor([int(state)]), torch.zeros(1, dtype=torch.long)
    t_streams = torch.from_numpy(streams.astype(np.int64))
    out = []
    for i in range(n):
        js, j_st, j_ptr = jrans.decode_step(j_st, j_ptr, jnp.asarray(streams),
                                            jnp.asarray(freq[i:i + 1]),
                                            jnp.asarray(cdf_low[i:i + 1]), jnp.asarray([True]))
        ts, t_st, t_ptr = trans.decode_step(
            t_st, t_ptr, t_streams, torch.from_numpy(freq[i:i + 1].astype(np.int64)),
            torch.from_numpy(cdf_low[i:i + 1].astype(np.int64)), torch.tensor([True]))
        assert int(ts[0]) == int(js[0])
        assert int(t_st[0]) == int(np.asarray(j_st)[0])
        assert int(t_ptr[0]) == int(np.asarray(j_ptr)[0])
        out.append(int(ts[0]))
    np.testing.assert_array_equal(out, syms)


def test_decode_step_inactive_lanes_keep_their_state():
    """Several lanes at once, some inactive: those keep state and pointer
    and return 0, as in the JAX function."""
    rng = np.random.RandomState(5)
    M, W = 8, 16
    freq, cdf_low = _random_tables(rng, M)
    states = rng.randint(1 << 16, 1 << 31, M).astype(np.uint32)
    ptrs = rng.randint(0, W, M).astype(np.int32)
    streams = rng.randint(0, 1 << 16, (M, W)).astype(np.uint32)
    active = rng.rand(M) < 0.5
    js, jst, jp = jax.device_get(jrans.decode_step(
        jnp.asarray(states), jnp.asarray(ptrs), jnp.asarray(streams), jnp.asarray(freq),
        jnp.asarray(cdf_low), jnp.asarray(active)))
    ts, tst, tp = trans.decode_step(
        torch.from_numpy(states.astype(np.int64)), torch.from_numpy(ptrs),
        torch.from_numpy(streams.astype(np.int64)), torch.from_numpy(freq.astype(np.int64)),
        torch.from_numpy(cdf_low.astype(np.int64)), torch.from_numpy(active))
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tst.numpy().astype(np.uint32), jst)
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert (ts.numpy()[~active] == 0).all()
    np.testing.assert_array_equal(tst.numpy()[~active], states[~active])
