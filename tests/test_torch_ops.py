"""Plain versions of the port's kernels against the JAX package's Pallas
kernels (interpret mode on the CPU), on the same numpy inputs, in f32.

Tolerances, f32: 1e-5 where both sides compute the same sums in another
order (LayerNorm, voxel embed); 1e-4 where the JAX kernel's GELU uses the
A&S 7.1.26 erf (abs error 1.5e-7, summed over the hidden layer) or its
softmax runs online over KV tiles against the plain version's whole row.
The training entries (forward and backward, autograd) are held against
``jax.grad`` through the Pallas kernels' custom VJPs: LayerNorm to 1e-5
(dgamma/dbeta sums over 300 rows: 1e-4 absolute), LN+MLP and flash to 1e-4
relative (weight gradients sum over all rows: 1e-4 of their largest value).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev.configs import GridConfig  # noqa: E402
from intentbev.ops import flash_packed as jfp  # noqa: E402
from intentbev.ops import voxel_embed as jve  # noqa: E402
from intentbev.ops.fused_ln_mlp import fused_ln_mlp as jax_fused_ln_mlp  # noqa: E402
from intentbev.ops.layernorm import fused_layernorm as jax_layernorm  # noqa: E402
from intentbev_torch.ops import (flash_attention_fn, flash_attention_packed,  # noqa: E402
                                 fused_ln_mlp, fused_ln_mlp_fn, layernorm, layernorm_fn,
                                 voxel_embed_tokens)
from intentbev_torch.ops.voxel_embed import VoxelChunks  # noqa: E402

GRID = GridConfig(height_px=80, width_px=96, lidar_height_channels=4, lidar_sweeps=2)
PATCH = 8
# widths of the row kernels' cases: a lane-aligned one and ViT-Ti's 192 (the
# port's kernels take 192 and 384), hidden 4x
WIDTHS = [128, 192]
# the module (``intentbev.ops`` re-exports a function of the same name)
jfm = importlib.import_module("intentbev.ops.fused_mlp")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("d", WIDTHS)
def test_layernorm_matches_pallas(rng, d):
    x = rng.normal(0.5, 2.0, (300, d)).astype(np.float32)
    g = rng.normal(1.0, 0.3, d).astype(np.float32)
    b = rng.normal(0.0, 0.3, d).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    got = layernorm(_t(x), _t(g), _t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("gelu", ["erf", "sigmoid"])
def test_fused_ln_mlp_ln_out_matches_pallas(rng, gelu, monkeypatch, d):
    monkeypatch.setattr(jfm, "_GELU_MODE", gelu)
    n, hid = 300, 4 * d
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    ln = [rng.normal(1 - i % 2, 0.2, d).astype(np.float32) for i in range(4)]
    w1 = rng.normal(0, d ** -0.5, (d, hid)).astype(np.float32)   # JAX [in, out]
    b1 = rng.normal(0, 0.1, hid).astype(np.float32)
    w2 = rng.normal(0, hid ** -0.5, (hid, d)).astype(np.float32)
    b2 = rng.normal(0, 0.1, d).astype(np.float32)
    j = [jnp.asarray(a) for a in (x, ln[0], ln[1], w1, b1, w2, b2)]
    with pltpu.force_tpu_interpret_mode():
        y_w, yn_w = jax_fused_ln_mlp(*j, ln_out=(jnp.asarray(ln[2]), jnp.asarray(ln[3])))
    y, yn = fused_ln_mlp(_t(x), _t(ln[0]), _t(ln[1]), _t(w1.T.copy()), _t(b1),
                         _t(w2.T.copy()), _t(b2), _t(ln[2]), _t(ln[3]),
                         gelu_mode=gelu)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_w), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(yn.numpy(), np.asarray(yn_w), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("unsafe", [False, True])
@pytest.mark.parametrize("kv_chunk", [0, 128])
def test_flash_packed_matches_pallas(rng, kv_chunk, unsafe):
    b, t, h, seq_len = 2, 300, 6, 283  # ragged: keys >= 283 are masked
    dm = h * 64
    q, k, v = (rng.normal(0, 1, (b, t, dm)).astype(np.float32) for _ in range(3))
    t_pad = 768  # the JAX wrapper's padding: lcm of its row blocks

    def pad(a):
        return jnp.asarray(np.pad(a, ((0, 0), (0, t_pad - t), (0, 0))))

    with pltpu.force_tpu_interpret_mode():
        o_w, lse_w = jfp._fwd(pad(q), pad(k), pad(v), h, 64 ** -0.5, seq_len,
                              kv_chunk, safe=not unsafe)
    o, lse = flash_attention_packed(_t(q), _t(k), _t(v), h, seq_len)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_w)[:, :t], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_w)[:, :, :t, 0],
                               atol=1e-4, rtol=1e-5)


def _points(rng, s=2, p=1500):
    pts = np.empty((s, p, 4), np.float32)
    pts[..., 0] = rng.uniform(GRID.bev_x_min, GRID.bev_x_max, (s, p))
    pts[..., 1] = rng.uniform(GRID.bev_y_min, GRID.bev_y_max, (s, p))
    pts[..., 2] = rng.uniform(-3, 5, (s, p))
    pts[..., 3] = rng.uniform(0, 255, (s, p))
    return pts, rng.uniform(size=(s, p)) < 0.9


@pytest.mark.parametrize("d", [64, 192])
def test_voxel_embed_matches_pallas(rng, d):
    """Two samples, the second empty; one cell's channel set to C (the TPU
    kernel's one-hot drops it, the port skips it)."""
    c = GRID.lidar_total_channels
    pts, valid = _points(rng)
    full, _ = jve.build_voxel_chunks(pts, valid, GRID, PATCH, num_chunks=64)
    empty, _ = jve.build_voxel_chunks(pts, np.zeros_like(valid), GRID, PATCH,
                                      num_chunks=64)
    chunks = jve.stack_voxel_chunks([full, empty])
    ch = np.asarray(chunks.ch).copy()
    ch[0, 0, 0, 0, 0] = c
    chunks = chunks._replace(ch=ch)
    kern = rng.normal(0, 0.05, (PATCH, PATCH, c, d)).astype(np.float32)
    bias = rng.normal(0, 0.1, d).astype(np.float32)
    hw = (GRID.height_px, GRID.width_px)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jve.voxel_embed_tokens(
            VoxelChunks(*(jnp.asarray(a) for a in chunks)), jnp.asarray(kern),
            jnp.asarray(bias), PATCH, hw))
    got = voxel_embed_tokens(VoxelChunks(*(_t(a) for a in chunks)), _t(kern),
                             _t(bias), PATCH, hw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[1], np.broadcast_to(bias, got[1].shape))


def _close(got, want, rel, name):
    """max|got - want| <= rel * max|want| (gradients summed over many rows)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), f"{name}: {err} vs {np.abs(want).max()}"


def _leaf(a):
    return _t(a).clone().requires_grad_(True)


@pytest.mark.parametrize("d", WIDTHS)
def test_layernorm_grad_matches_pallas(rng, d):
    x = rng.normal(0.5, 2.0, (300, d)).astype(np.float32)
    g = rng.normal(1.0, 0.3, d).astype(np.float32)
    b = rng.normal(0.0, 0.3, d).astype(np.float32)
    dy = rng.normal(0, 1, (300, d)).astype(np.float32)

    def loss(x_, g_, b_):
        return jnp.sum(jax_layernorm(x_, g_, b_) * jnp.asarray(dy))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, g, b)))
    leaves = [_leaf(a) for a in (x, g, b)]
    y = layernorm_fn(*leaves)
    (y * _t(dy)).sum().backward()
    for name, leaf, w, tol in zip(("dx", "dgamma", "dbeta"), leaves, want, (1e-5, 1e-5, 1e-5)):
        _close(leaf.grad.numpy(), w, tol, name)
    with torch.no_grad():  # no gradient: the inference kernel's plain twin
        np.testing.assert_allclose(layernorm_fn(*leaves).numpy(), y.detach().numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("gated", [False, True])
def test_fused_ln_mlp_grad_matches_pallas(rng, gated, d):
    """Gate None, and a per-sample 0-or-1/keep gate broadcast over tokens."""
    b, t, hid = 3, 100, 4 * d
    x = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    gamma = rng.normal(1, 0.2, d).astype(np.float32)
    beta = rng.normal(0, 0.2, d).astype(np.float32)
    w1 = rng.normal(0, d ** -0.5, (d, hid)).astype(np.float32)   # JAX [in, out]
    b1 = rng.normal(0, 0.1, hid).astype(np.float32)
    w2 = rng.normal(0, hid ** -0.5, (hid, d)).astype(np.float32)
    b2 = rng.normal(0, 0.1, d).astype(np.float32)
    dy = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    gate = (np.array([1.0, 0.0, 1.0], np.float32) / 0.9)[:, None] * np.ones((b, t), np.float32)
    gate_j = jnp.asarray(gate) if gated else None

    def loss(*a):
        return jnp.sum(jax_fused_ln_mlp(*a, gate=gate_j) * jnp.asarray(dy))

    args = (x, gamma, beta, w1, b1, w2, b2)
    with pltpu.force_tpu_interpret_mode():
        y_w = jax_fused_ln_mlp(*map(jnp.asarray, args), gate=gate_j)
        want = jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, args))
    torch_args = (x, gamma, beta, w1.T.copy(), b1, w2.T.copy(), b2)
    leaves = [_leaf(a) for a in torch_args]
    y = fused_ln_mlp_fn(*leaves, gate=_t(gate) if gated else None)
    _close(y.detach().numpy(), y_w, 1e-5, "y")
    (y * _t(dy)).sum().backward()
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for i, (name, leaf, w) in enumerate(zip(names, leaves, want)):
        w = np.asarray(w)
        if name in ("dw1", "dw2"):
            w = w.T
        _close(leaf.grad.numpy(), w, 1e-4, name)


def test_flash_grad_matches_pallas(rng):
    """Ragged: keys >= seq_len are masked, their dk and dv are 0."""
    b, t, h, seq_len = 2, 300, 6, 283
    dm = h * 64
    q, k, v, do = (rng.normal(0, 1, (b, t, dm)).astype(np.float32) for _ in range(4))

    def loss(q_, k_, v_):
        return jnp.sum(jfp.flash_attention_packed(q_, k_, v_, h, seq_len) * jnp.asarray(do))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qkv = _leaf(np.concatenate([q, k, v], -1))
    o = flash_attention_fn(qkv, h, seq_len)
    (o * _t(do)).sum().backward()
    got = qkv.grad.numpy()
    for j, (name, w) in enumerate(zip(("dq", "dk", "dv"), want)):
        _close(got[..., j * dm:(j + 1) * dm], w, 1e-4, name)
    assert not got[:, seq_len:, dm:].any()
