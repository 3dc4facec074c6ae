"""The port's numerics against the JAX package's, on the same numpy inputs.

Everything here is bit-exact (``assert_array_equal``): the FP8 STE quantizer,
the ExMy codec, the compensation LUTs and the exact powers of two.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fp8_quantization_tpu.numerics import codec as jcodec
from fp8_quantization_tpu.numerics import fp8_ste as jste
from fp8_quantization_tpu.numerics import luts as jluts
from fp8_quantization_tpu.numerics import rounding as jround
from fp8_quantization_tpu_torch.numerics import codec as tcodec
from fp8_quantization_tpu_torch.numerics import fp8_ste as tste
from fp8_quantization_tpu_torch.numerics import formats as tformats
from fp8_quantization_tpu_torch.numerics import luts as tluts
from fp8_quantization_tpu_torch.numerics import rounding as tround

torch.set_num_threads(1)  # the suite's test workers share the machine's cores


def _edge_values(rng, n=512, scale=3.0):
    """Random normals plus zero, signed zero, f32 subnormals, tiny normals and
    large magnitudes (clip edges)."""
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 1.2e-38, 2.0 ** -126,
                        2.0 ** -20, 0.5, 1.0, 1.5, 2.0, 7.5, 15.5, 16.0, 240.0, 1e4,
                        -1e4, 3.4e38], np.float32)
    x = (rng.normal(size=n) * scale).astype(np.float32)
    return np.concatenate([special, x, x * 2.0 ** -10, x * 64])


@pytest.mark.parametrize("mbits,sign_bits", [(4, 1), (3, 1), (2, 1), (4, 0)])
def test_quantize_to_fp8_ste_per_tensor(rng, mbits, sign_bits):
    x = _edge_values(rng)
    for maxval in (np.array([4.0], np.float32), np.array([3.1], np.float32),
                   np.array([240.0], np.float32), np.array([0.013], np.float32)):
        jy, jb = jste.quantize_to_fp8_ste(jnp.asarray(x), 8, jnp.asarray(maxval),
                                          jnp.float32(mbits), sign_bits)
        ty, tb = tste.quantize_to_fp8_ste(torch.from_numpy(x), 8, torch.from_numpy(maxval),
                                          torch.tensor(float(mbits)), sign_bits)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_quantize_to_fp8_ste_per_channel(rng):
    """(C,) maxval broadcasts along the leading axis, and a maxval already
    shaped for the last axis (the weight quantizer's layout) broadcasts as is."""
    x = (rng.normal(size=(6, 5, 7)) * 2).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 0, 0] = 1e-40
    mv = np.abs(rng.normal(size=6)).astype(np.float32) + 0.1
    jy, jb = jste.quantize_to_fp8_ste(jnp.asarray(x), 8, jnp.asarray(mv), jnp.float32(4), 1)
    ty, tb = tste.quantize_to_fp8_ste(torch.from_numpy(x), 8, torch.from_numpy(mv),
                                      torch.tensor(4.0), 1)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))

    mv_last = (np.abs(rng.normal(size=(1, 1, 7))) + 0.1).astype(np.float32)
    jy, jb = jste.quantize_to_fp8_ste(jnp.asarray(x), 8, jnp.asarray(mv_last),
                                      jnp.float32(4), 1)
    ty, tb = tste.quantize_to_fp8_ste(torch.from_numpy(x), 8, torch.from_numpy(mv_last),
                                      torch.tensor(4.0), 1)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_quantize_to_fp8_ste_gradients(rng):
    """The autograd.Functions give the JAX custom_vjp gradients: identity
    through the rounds, ln2·2^arg through the power of two. The backward
    chains through log2 and products, so they agree to f32 rounding."""
    x = (rng.normal(size=64) * 3).astype(np.float32)
    mv = np.array([2.7], np.float32)

    def jloss(x, mv):
        return jnp.sum(jste.quantize_to_fp8_ste(x, 8, mv, jnp.float32(4), 1)[0] ** 2)

    jgx, jgm = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(mv))
    tx = torch.from_numpy(x).requires_grad_()
    tm = torch.from_numpy(mv).requires_grad_()
    (tste.quantize_to_fp8_ste(tx, 8, tm, torch.tensor(4.0), 1)[0] ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jgm), rtol=1e-5, atol=1e-6)


def test_default_maxval_and_bias():
    for n_bits, m in itertools.product((8, 7), (1, 2, 3, 4, 5)):
        assert tste.default_maxval(n_bits, m) == jste.default_maxval(n_bits, m)
    for e in (2, 3, 4, 5):
        assert tformats.default_bias(e) == (1 << (e - 1)) - 1
        assert tformats.ExMy.create(e, 3).max_norm > 0


def test_exact_powers_of_two():
    e = np.arange(-126, 128, dtype=np.int32)
    np.testing.assert_array_equal(tround.exp2_exact(torch.from_numpy(e.astype(np.float32))).numpy(),
                                  np.asarray(jround.exp2_exact(jnp.asarray(e, jnp.float32))))
    # over the normal range: XLA's CPU backend flushes subnormal results to
    # zero, the port keeps them exact (checked against numpy below)
    np.testing.assert_array_equal(tround.exp2_int(torch.from_numpy(e)).numpy(),
                                  np.asarray(jround.exp2_int(jnp.asarray(e))))
    x = np.array([0.75, -1.5, 1.0], np.float32)
    assert tround.round_ste(torch.tensor([0.5, 1.5, 2.5, -0.5])).tolist() == [0.0, 2.0, 2.0, -0.0]
    np.testing.assert_array_equal(
        tround.ldexp(torch.from_numpy(x), torch.tensor([-140, 100, 127])).numpy(),
        np.ldexp(x, [-140, 100, 127]).astype(np.float32))


def test_to_int32_saturates_as_xla():
    """Biases reach int32 as XLA converts them: NaN to 0, out-of-range values
    (the +inf bias of a zero-range site) saturated, the rest truncated."""
    x = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.5, -2.5, 7.0], np.float32)
    np.testing.assert_array_equal(tround.to_int32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.asarray(x).astype(jnp.int32)))
    assert tround.to_int32(torch.tensor([5], dtype=torch.int64)).dtype == torch.int32


FORMATS = [(3, 4), (4, 3), (2, 5)]


@pytest.mark.parametrize("ew,mw", FORMATS)
@pytest.mark.parametrize("clip_of", [False, True])
def test_codec_bit_exact(rng, ew, mw, clip_of):
    x = _edge_values(rng, n=256)
    for bias in (default := (1 << (ew - 1)) - 1, default + 3, -2):
        je, jm = jcodec.decompose(jnp.asarray(x), mw, bias, expo_width=ew, clip_of=clip_of)
        te, tm = tcodec.decompose(torch.from_numpy(x), mw, bias, expo_width=ew, clip_of=clip_of)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(
            tcodec.compose(te, tm, mw, bias).numpy(),
            np.asarray(jcodec.compose(je, jm, mw, bias)))
        np.testing.assert_array_equal(
            tcodec.quantize_exmy(torch.from_numpy(x), ew, mw, bias, clip_of=clip_of).numpy(),
            np.asarray(jcodec.quantize_exmy(jnp.asarray(x), ew, mw, bias, clip_of=clip_of)))
        np.testing.assert_array_equal(
            tcodec.quantize_exmy_allnorm(torch.from_numpy(x), ew, mw, bias,
                                         clip_of=clip_of).numpy(),
            np.asarray(jcodec.quantize_exmy_allnorm(jnp.asarray(x), ew, mw, bias,
                                                    clip_of=clip_of)))


def test_codec_per_column_bias(rng):
    """A (1, N) bias vector broadcasts over the columns of a (K, N) operand."""
    x = (rng.normal(size=(9, 6)) * 4).astype(np.float32)
    x[0, :] = [0.0, 1e-40, -1e-3, 300.0, -0.0, 2.0 ** -8]
    bias = np.array([[3, 4, 5, 6, 1, 9]], np.int32)
    je, jm = jcodec.decompose(jnp.asarray(x), 4, jnp.asarray(bias))
    te, tm = tcodec.decompose(torch.from_numpy(x), 4, torch.from_numpy(bias))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        tcodec.quantize_exmy(torch.from_numpy(x), 3, 4, torch.from_numpy(bias)).numpy(),
        np.asarray(jcodec.quantize_exmy(jnp.asarray(x), 3, 4, jnp.asarray(bias))))


def _table_or_error(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return type(e)


@pytest.mark.parametrize("ew,mw", FORMATS + [(5, 2), (6, 1)])
def test_error_tables_every_selection(ew, mw):
    """Every (format, with_comp, dnsmp_factor) the JAX selector accepts gives
    the same table, and every one it rejects raises the same error."""
    for with_comp, dnsmp in itertools.product((False, True), range(0, 8)):
        j = _table_or_error(jluts.get_error_table, ew, mw, with_comp, dnsmp)
        t = _table_or_error(tluts.get_error_table, ew, mw, with_comp, dnsmp)
        if isinstance(j, type):
            assert t is j
        else:
            assert t.dtype == np.int32
            np.testing.assert_array_equal(t, j)
