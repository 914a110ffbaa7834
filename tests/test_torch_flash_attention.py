"""The BHTD attention of the port (``intentbev_torch/ops/flash_attention.py``)
against the JAX package's Pallas kernels (``intentbev/ops/flash_attention.py``,
interpret mode on the CPU), and the packed entries' dispatch against the JAX
``flash_attention_packed``, which falls back to those kernels when the heads
do not pair into 128 lanes.

Inputs are made with numpy and handed to both sides in the working dtype.
Tolerances: f32, 1e-5 relative to the largest value for o, lse and the
gradients (both sides compute the same f32 sums in another order); bf16,
both sides round the same f32 values at the same points, so a value differs
only where the summation order tips it to the neighbouring bf16: 1.6e-2 of
the largest value (four bf16 ulps of it), and at most 2 % of the elements of
o, dq, dk and dv may differ at all. A rounding point moved (the f32 scale in
place of the bf16 one at head dim 32, or dq scaled before its bf16 rounding)
changes far more than 2 % of dq's elements; the last test shows that the
check sees it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev_torch.ops import flash_attention_fn, flash_attention_packed  # noqa: E402
from intentbev_torch.ops.flash_attention import flash_attention  # noqa: E402

# the modules (``intentbev.ops`` and ``intentbev_torch.ops`` re-export
# functions of the same names)
jfa = importlib.import_module("intentbev.ops.flash_attention")
jfp = importlib.import_module("intentbev.ops.flash_packed")
tfa = importlib.import_module("intentbev_torch.ops.flash_attention")
tfp = importlib.import_module("intentbev_torch.ops.flash_packed")

B, H, T, SEQ_LEN = 2, 3, 300, 283  # ragged: keys >= 283 are masked
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _inputs(rng, d, shape=None):
    shape = shape or (B, H, T, d)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(4)]


def _jax_reference(q, k, v, do, jdt):
    """JAX forward o, lse (the kernel's own output) and gradients."""
    qj, kj, vj, doj = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    d = q.shape[-1]

    def loss(q_, k_, v_):
        o_ = jfa.flash_attention(q_, k_, v_, seq_len=SEQ_LEN)
        return jnp.sum(o_.astype(jnp.float32) * doj.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        o = jfa.flash_attention(qj, kj, vj, seq_len=SEQ_LEN)
        t_pad = jfa._pad_len(T, jfa.BLOCK_Q)

        def prep(x):
            return jnp.pad(x.reshape(B * H, T, d), ((0, 0), (0, t_pad - T), (0, 0)))

        qs = qj * jnp.asarray(d ** -0.5, jdt)
        lse = jfa._fwd(prep(qs), prep(kj), prep(vj), SEQ_LEN)[1]
        grads = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    lse = np.asarray(lse)[:, :T, 0].reshape(B, H, T)
    return [np.asarray(a, np.float32) for a in (o, *grads)], lse


def _port(q, k, v, do, tdt, seq_len=SEQ_LEN):
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    o = flash_attention(*leaves, seq_len)
    (o.float() * torch.from_numpy(do).to(tdt).float()).sum().backward()
    lse = tfa.flash_attention_fwd_plain(*(x.detach() for x in leaves), seq_len)[1]
    return [a.detach().float().numpy() for a in (o, *(x.grad for x in leaves))], lse.numpy()


def _differ(got, want, name, rel, share):
    """max|got - want| <= rel * max|want|, and at most ``share`` of the
    elements differ at all."""
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{name}: {err} vs {np.abs(want).max()}"
    frac = float((got != want).mean())
    assert frac <= share, f"{name}: {frac:.4f} of the elements differ"
    return frac


@pytest.mark.parametrize("d", [64, 32])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_pallas(rng, dtype, d):
    """3 heads, T=300 with keys past 283 masked: o and lse of the forward,
    dq, dk and dv of the backward (jax.grad through the custom VJP); the
    padded keys' dk and dv exactly 0."""
    _, jdt, tdt = DTYPES[dtype]
    q, k, v, do = _inputs(rng, d)
    if dtype == "bf16":  # both sides start from the same bf16 values
        q, k, v, do = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                       for a in (q, k, v, do))
    want, want_lse = _jax_reference(q, k, v, do, jdt)
    got, lse = _port(q, k, v, do, tdt)
    rel, share = (1e-5, 1.0) if dtype == "f32" else (1.6e-2, 2e-2)
    for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        _differ(a, w, name, rel, share)
    np.testing.assert_allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert not got[2][:, :, SEQ_LEN:].any() and not got[3][:, :, SEQ_LEN:].any()


def _dq_scaled_before_rounding(bwd):
    """The plain backward with dq = bf16(scale * ds k) (the packed kernel's
    order, equal to the JAX one only where the scale is a power of two)."""
    def call(q, k, v, o, lse, do, seq_len=None):
        dq, dk, dv = bwd(q, k, v, o, lse, do, seq_len)
        sc = tfa._scale(q.shape[-1], q.dtype)
        for i in range(q.shape[0]):
            s = torch.matmul((q[i] * sc).float(), k[i].float().transpose(-1, -2))
            s[..., seq_len:] = float("-inf")
            p = torch.exp(s - lse[i][..., None])
            delta = (do[i].float() * o[i].float()).sum(-1, keepdim=True)
            ds = (p * (torch.matmul(do[i].float(), v[i].float().transpose(-1, -2)) - delta))
            dq[i] = (torch.matmul(ds.to(q.dtype).float(), k[i].float()) * float(sc)).to(q.dtype)
        return dq, dk, dv
    return call


@pytest.mark.parametrize("fault", ["f32 scale", "dq scaled before rounding"])
def test_moved_rounding_points_are_seen(rng, monkeypatch, fault):
    """The bf16 check at head dim 32 fails for a plain version with either
    fault: q (and dq) scaled by the f32 scale, or dq scaled in f32 before its
    bf16 rounding. (Sound, under 0.5 % of the elements differ; with either
    fault 23-38 % of dq's.)"""
    q, k, v, do = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in _inputs(rng, 32))
    want = _jax_reference(q, k, v, do, jnp.bfloat16)[0]
    if fault == "f32 scale":
        monkeypatch.setattr(tfa, "_scale", lambda d, dtype: torch.tensor(d ** -0.5))
    else:
        monkeypatch.setattr(tfa, "flash_attention_bwd_plain",
                            _dq_scaled_before_rounding(tfa.flash_attention_bwd_plain))
    got = _port(q, k, v, do, torch.bfloat16)[0]
    with pytest.raises(AssertionError, match="dq"):
        _differ(got[1], want[1], "dq", 1.6e-2, 2e-2)


def _packed_inputs(rng, heads):
    return [rng.normal(0, 1, (B, T, heads * 64)).astype(np.float32) for _ in range(4)]


def test_packed_unpaired_matches_jax_fallback(rng):
    """3 heads of 64 do not pair into 128 lanes: the port's packed entries
    and the JAX ``flash_attention_packed`` both take the BHTD kernels (f32)."""
    q, k, v, do = _packed_inputs(rng, 3)

    def loss(q_, k_, v_):
        return jnp.sum(jfp.flash_attention_packed(q_, k_, v_, 3, SEQ_LEN) * jnp.asarray(do))

    with pltpu.force_tpu_interpret_mode():
        o_w = jfp.flash_attention_packed(*map(jnp.asarray, (q, k, v)), 3, SEQ_LEN)
        g_w = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    o = flash_attention_packed(*map(torch.from_numpy, (q, k, v)), 3, SEQ_LEN)[0]
    np.testing.assert_allclose(o.numpy(), np.asarray(o_w), rtol=1e-5, atol=1e-5)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_(True)
    o2 = flash_attention_fn(qkv, 3, SEQ_LEN)
    np.testing.assert_allclose(o2.detach().numpy(), np.asarray(o_w), rtol=1e-5, atol=1e-5)
    (o2 * torch.from_numpy(do)).sum().backward()
    dm = 3 * 64
    for j, (name, w) in enumerate(zip(("dq", "dk", "dv"), g_w)):
        _differ(qkv.grad.numpy()[..., j * dm:(j + 1) * dm], np.asarray(w), name, 1e-5, 1.0)


@pytest.mark.parametrize("heads, bhtd", [(3, True), (6, False), (1, True)])
def test_dispatch_follows_head_pairing(rng, monkeypatch, heads, bhtd):
    """Counted: the model's entries (forward-only and differentiable) reach
    the BHTD versions exactly when the heads do not pair into 128 lanes, and
    the packed ones otherwise."""
    calls = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrap(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)

    counted(tfa, "flash_attention_fwd_plain")
    counted(tfa, "flash_attention_bwd_plain")
    counted(tfp, "flash_attention_packed_plain")
    counted(tfp, "flash_attention_packed_bwd_plain")
    q, k, v, do = (torch.from_numpy(a) for a in _packed_inputs(rng, heads))
    flash_attention_packed(q, k, v, heads)
    qkv = torch.cat([q, k, v], -1).requires_grad_(True)
    (flash_attention_fn(qkv, heads) * do).sum().backward()
    if bhtd:
        want = {"flash_attention_fwd_plain": 2, "flash_attention_bwd_plain": 1}
    else:
        want = {"flash_attention_packed_plain": 2, "flash_attention_packed_bwd_plain": 1}
    assert calls == want
    assert tfp.pairs_heads(64, heads) is not bhtd
