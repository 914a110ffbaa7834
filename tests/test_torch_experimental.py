"""The port's experimental ops (``intentbev_torch.ops.experimental``) against
the JAX package's, on the CPU: the int8 packed attention
(``flash_attention_packed_int8``) and the residual projection
(``fused_dense_residual``, forward and backward).

The JAX side is the Pallas kernels in interpret mode, fed the same numpy
inputs as the port's plain versions (from a named seed). The JAX functions
are compiled with two XLA rewrites off, so that they round where their
source does, as the TPU's compiler does inside a kernel:

- ``xla_disable_hlo_passes=algsimp``: XLA's algebraic simplifier turns
  ``x / 127.0`` into ``x * f32(1/127)``, one ulp off the quotient in a few
  percent of the int8 scales; at bf16 inputs, where ``x / s`` often lands
  on a tie, that flips codes (``test_xla_rewrite_that_the_compile_options_undo``);
- ``xla_allow_excess_precision=False``: XLA's CPU backend otherwise keeps a
  bf16 value in f32 where a dot reads it (``dyg_c`` in the backward).

Tolerances: f32, the same f32 sums in another order (denom, the dot
products, the column sums): 1e-6 of the largest value for o and y, 1e-5
for the gradients; bf16, both sides round the same f32 values at the same
points, so an element differs only where the summation order tips it to
the neighbouring bf16: at most 1.6e-2 of the largest value, and at most
0.1 % of the elements may differ (sound readings <= 0.003 % for o, 0.024 %
for dW). db and d residual are compared in f32 (1e-5) and exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev_torch.ops import launches  # noqa: E402
from intentbev_torch.ops.experimental import (  # noqa: E402
    flash_attention_packed_int8, flash_attention_packed_int8_plain, fused_dense_residual,
    fused_proj_bwd_plain)

jint8 = importlib.import_module("intentbev.ops.experimental.flash_int8")
jproj = importlib.import_module("intentbev.ops.experimental.fused_proj")
tint8 = importlib.import_module("intentbev_torch.ops.experimental.flash_int8")

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
AS_WRITTEN = {"xla_disable_hlo_passes": "algsimp", "xla_allow_excess_precision": False}
BF16_REL, BF16_SHARE = 1.6e-2, 1e-3


def _close(got, want, dtype, name, f32_rel=1e-6):
    """max|got - want| under f32_rel (f32) or BF16_REL (bf16) of max|want|;
    in bf16 at most BF16_SHARE of the elements differ."""
    err = np.abs(got - want).max()
    rel = f32_rel if dtype == "f32" else BF16_REL
    assert err <= rel * np.abs(want).max(), f"{name}: {err} vs max {np.abs(want).max()}"
    if dtype == "bf16":
        frac = float((got != want).mean())
        assert frac <= BF16_SHARE, f"{name}: {frac:.5f} of the elements differ"


def _arrays(rng, dtype, *shapes, std=1.0):
    """f32 numpy arrays (writable) exactly representable in ``dtype``."""
    jdt = DTYPES[dtype][0]
    return [np.array(jnp.asarray(rng.normal(0, std, s), jdt).astype(jnp.float32))
            for s in shapes]


def _jax_int8(q, k, v, heads, seq_len, dtype):
    jdt = DTYPES[dtype][0]
    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        fn = jax.jit(lambda q_, k_, v_: jint8.flash_attention_packed_int8(
            q_, k_, v_, heads, seq_len=seq_len))
        o = fn.lower(*args).compile(compiler_options=AS_WRITTEN)(*args)
    return np.asarray(o.astype(jnp.float32))


def _port_int8(q, k, v, heads, seq_len, dtype, **kw):
    tdt = DTYPES[dtype][1]
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    return flash_attention_packed_int8_plain(*t, heads, seq_len, **kw).float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,seq_len", [(384, None), (768, 700)])
@pytest.mark.parametrize("dh", [64, 32])
def test_int8_attention_matches_jax(dh, t, seq_len, dtype):
    """o of the plain version against the JAX kernel at 2 (dh 64) or 4 (dh
    32) heads a 128-lane panel, with and without masked keys."""
    rng = np.random.default_rng(18)
    b, dm = (1, 128) if t == 768 else (2, 128)
    q, k, v = _arrays(rng, dtype, *[(b, t, dm)] * 3)
    want = _jax_int8(q, k, v, dm // dh, seq_len, dtype)
    got = _port_int8(q, k, v, dm // dh, seq_len, dtype)
    assert got.shape == want.shape == (b, t, dm)
    _close(got, want, dtype, "o")


@pytest.mark.parametrize("dh", [64, 32])
def test_int8_attention_v_scale_takes_masked_rows(dh):
    """sv is the absmax over every row of v, those at or past seq_len too: v's
    rows there are scaled x50, so a version that takes sv over the real rows
    only (the control) misses by far more than the tolerance."""
    rng = np.random.default_rng(19)
    t, seq_len, dm = 768, 700, 128
    q, k, v = _arrays(rng, "bf16", *[(1, t, dm)] * 3)
    v[:, seq_len:] *= 50.0  # powers of two times bf16 values stay exact
    want = _jax_int8(q, k, v, dm // dh, seq_len, "bf16")
    _close(_port_int8(q, k, v, dm // dh, seq_len, "bf16"), want, "bf16", "o")
    real_rows = v.copy()
    real_rows[:, seq_len:] = 0.0  # the masked keys' v is never read otherwise
    ctl = _port_int8(q, k, real_rows, dm // dh, seq_len, "bf16")
    assert np.abs(ctl - want).max() > 10 * BF16_REL * np.abs(want).max()


def test_xla_rewrite_that_the_compile_options_undo():
    """Why the JAX side is compiled with ``algsimp`` off: under jit XLA
    turns ``x / 127.0`` into ``x * f32(1/127)`` (a few percent of the scales
    differ from the quotient, none from the product), and at bf16 inputs
    the moved scales flip enough codes to move more than 1 % of o."""
    rng = np.random.default_rng(22)
    a = np.abs(rng.normal(0, 2, 10000)).astype(np.float32)
    jitted = np.asarray(jax.jit(lambda a_: jnp.maximum(a_, 1e-8) / 127.0)(a))
    np.testing.assert_array_equal(jitted, a * np.float32(1 / 127))
    assert 0.01 < float((jitted != a / np.float32(127)).mean()) < 0.1
    q, k, v = _arrays(rng, "bf16", *[(1, 384, 128)] * 3)
    args = [jnp.asarray(x_, jnp.bfloat16) for x_ in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        rewritten = np.asarray(jax.jit(lambda q_, k_, v_: jint8.flash_attention_packed_int8(
            q_, k_, v_, 2))(*args).astype(jnp.float32))
    port = _port_int8(q, k, v, 2, None, "bf16")
    assert float((rewritten != port).mean()) > 0.01
    _close(port, _jax_int8(q, k, v, 2, None, "bf16"), "bf16", "o")


def test_int8_attention_control_is_caught():
    """The on-card checks' control (P's codes rounded against a running
    tile max) differs from JAX by far more than the tolerance."""
    rng = np.random.default_rng(20)
    q, k, v = _arrays(rng, "bf16", *[(1, 384, 128)] * 3)
    want = _jax_int8(q, k, v, 2, None, "bf16")
    ctl = _port_int8(q, k, v, 2, None, "bf16", p_max="tile")
    assert float((ctl != want).mean()) > 10 * BF16_SHARE


def test_int8_attention_cpu_entry_takes_the_plain_version():
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _arrays(rng, "bf16", *[(1, 130, 128)] * 3))
    before = dict(launches)
    got = flash_attention_packed_int8(q, k, v, 4, 100)
    assert torch.equal(got, flash_attention_packed_int8_plain(q, k, v, 4, 100))
    assert dict(launches) == before


def test_int8_attention_rejects_unpaired_heads():
    """JAX asserts that the heads pair into 128 lanes; the port raises."""
    x = torch.zeros(1, 8, 192)
    with pytest.raises(ValueError, match="pair"):
        flash_attention_packed_int8(x, x, x, 3)
    assert tint8._head_dim(384, 12) == 32 and tint8._head_dim(384, 6) == 64


GATES = {
    "none": lambda rng, b, n: None,
    "per token": lambda rng, b, n: ((rng.uniform(size=(b, n)) < 0.7) / 0.7).astype(np.float32),
    "per sample": lambda rng, b, n: ((rng.uniform(size=(b, 1)) < 0.7) / 0.9).astype(np.float32),
}


def _proj_inputs(rng, dtype, b=2, n=300, d_in=128, d_out=128):
    x, r, dy = _arrays(rng, dtype, (b, n, d_in), (b, n, d_out), (b, n, d_out))
    (w,) = _arrays(rng, dtype, (d_in, d_out), std=0.05)
    bias = rng.normal(0, 0.02, d_out).astype(np.float32)
    return x, w, bias, r, dy


def _jax_proj(x, w, bias, r, gate, dy, dtype):
    """y and jax.grad of sum(y * dy) over (x, w, b, residual, gate)."""
    jdt = DTYPES[dtype][0]
    args = [jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(bias), jnp.asarray(r, jdt),
            None if gate is None else jnp.asarray(gate), jnp.asarray(dy, jdt)]

    def y_of(x_, w_, b_, r_, g_):
        return jproj.fused_dense_residual(x_, w_, b_, r_, gate=g_)

    def loss(x_, w_, b_, r_, g_, dy_):
        return jnp.sum((y_of(x_, w_, b_, r_, g_) * dy_).astype(jnp.float32))

    def both(*a):
        return y_of(*a[:5]), jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*a)

    with pltpu.force_tpu_interpret_mode():
        y, grads = jax.jit(both).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    return [None if a is None else np.asarray(jnp.asarray(a).astype(jnp.float32))
            for a in (y, *grads)]


def _port_proj(x, w, bias, r, gate, dy, dtype, backward=True):
    tdt = DTYPES[dtype][1]
    xt, wt, rt = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (x, w, r))
    bt = torch.from_numpy(bias).requires_grad_(True)
    gt = None if gate is None else torch.from_numpy(gate).requires_grad_(True)
    y = fused_dense_residual(xt, wt, bt, rt, gt)
    if backward:
        y.backward(torch.from_numpy(dy).to(tdt))
    return [None if a is None else a.detach().float().numpy()
            for a in (y, xt.grad, wt.grad, bt.grad, rt.grad, None if gt is None else gt.grad)]


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_proj_forward_matches_jax(dtype, gate):
    """y at N = 2 x 300 rows (not a multiple of JAX's 512-row block)."""
    rng = np.random.default_rng(190)
    x, w, bias, r, dy = _proj_inputs(rng, dtype)
    g = GATES[gate](rng, 2, 300)
    want = _jax_proj(x, w, bias, r, g, dy, dtype)[0]
    got = _port_proj(x, w, bias, r, g, dy, dtype, backward=False)[0]
    assert got.shape == want.shape == (2, 300, 128)
    _close(got, want, dtype, "y")


@pytest.mark.parametrize("gate", ["none", "per token"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_proj_backward_matches_jax(dtype, gate):
    """dx, dW, db, d residual and d gate (0, as the JAX VJP returns) through
    the autograd function, against jax.grad of the interpret-mode op."""
    rng = np.random.default_rng(191)
    x, w, bias, r, dy = _proj_inputs(rng, dtype, d_out=256)
    g = GATES[gate](rng, 2, 300)
    want = _jax_proj(x, w, bias, r, g, dy, dtype)
    got = _port_proj(x, w, bias, r, g, dy, dtype)
    for name, a, b in zip(("dx", "dw"), got[1:3], want[1:3]):
        _close(a, b, dtype, name, f32_rel=1e-5)
    _close(got[3], want[3], "f32", "db", f32_rel=1e-5)
    np.testing.assert_array_equal(got[4], want[4])  # d residual = dy
    if g is not None:
        assert not np.any(got[5]) and not np.any(want[5])


def test_fused_proj_db_takes_the_unrounded_dyg():
    """db sums dyg before its rounding to bf16: the control that sums the
    rounded dyg_c misses JAX's db by far more than the f32 tolerance."""
    rng = np.random.default_rng(192)
    x, w, bias, r, dy = _proj_inputs(rng, "bf16")
    g = GATES["per token"](rng, 2, 300)
    want_db = _jax_proj(x, w, bias, r, g, dy, "bf16")[3]
    x2 = torch.from_numpy(x).bfloat16().reshape(-1, 128)
    dy2 = torch.from_numpy(dy).bfloat16().reshape(-1, 128)
    gate2 = torch.from_numpy(g).reshape(-1, 1)
    sound = fused_proj_bwd_plain(x2, torch.from_numpy(w).bfloat16(), dy2, gate2)[2].numpy()
    ctl = (dy2.float() * gate2).bfloat16().float().sum(0).numpy()
    scale = np.abs(want_db).max()
    assert np.abs(sound - want_db).max() <= 1e-5 * scale
    assert np.abs(ctl - want_db).max() > 1e-3 * scale


def test_fused_proj_cpu_entry_counts_no_launch():
    rng = np.random.default_rng(193)
    x, w, bias, r, _ = _proj_inputs(rng, "bf16", b=1, n=10)
    before = dict(launches)
    y = fused_dense_residual(*(torch.from_numpy(a).bfloat16() for a in (x, w)),
                             torch.from_numpy(bias), torch.from_numpy(r).bfloat16())
    assert y.shape == (1, 10, 128) and y.dtype == torch.bfloat16
    assert dict(launches) == before
