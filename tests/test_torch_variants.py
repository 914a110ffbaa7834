"""The ViT's other serving configurations: the port against the JAX package
on the CPU.

Kernels: each new kernel's plain version against its Pallas kernel in
interpret mode, on the same numpy inputs in f32, at row counts that are not
a multiple of the TPU's 256-row block. Tolerances: 1e-4 where the Pallas
kernel's GELU uses the A&S 7.1.26 erf (abs error 1.5e-7) against the
port's exact erf, or sums come in another order; the W8A8 MLP reads
relative to its output's scale (1e-3), because a hidden value that the two
erfs put on either side of a rounding boundary moves one int8 code, and a
code step is 1/127 of its row's range.

Host copies: ``quantize_rows``/``quantize_cols`` give the JAX codes and
scales bit for bit (ties included), and the int8 codes the port loads
through ``from_flax`` are JAX's ``quantize_cols`` of the f32 parameters.

Model: ``tiny_test_config()`` with each switch against the JAX model's CPU
forward (erf GELU pinned), over the transport the configuration serves on
(chunks through the Pallas voxel embed in interpret mode, or points through
the port's voxelizer, whose BEV both sides take). f32 logits agree to 1e-4,
except the W8A8 configuration: there the JAX model takes the unfused
``int8_dense`` pair with the exact erf (``models/vit.py:211-218``), and the
logits agree to 3e-4 relative to their scale, room for a few of the code
flips above (this seed reads 5.5e-7: no code flips; a port that serves the
f32 MLP instead reads 2.2e-3).

Training: the backwards of the MLP without LN and of the LN + dense (their
autograd Functions on the CPU, so the plain backwards) against ``jax.grad``
through the Pallas kernels in interpret mode, every gradient, f32, to 1e-4
of each gradient's largest value (the A&S erf, and weight gradients summed
over 300 rows in another order). The training forward reaches the entries
each switch selects in the JAX model's training structure (its functions
are counted), and the dense attention of ``use_flash_attention=False``
matches the JAX ``reference_attention`` in bf16. A training step raises
under ``serving_int8`` (inference only) and for the sigmoid GELU.
"""

import collections
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev.bev.rasterize import decode_map_transport  # noqa: E402
from intentbev.models import build_model  # noqa: E402
from intentbev.ops.attention import reference_attention as jax_reference_attention  # noqa: E402
from intentbev.ops import int8 as jint8  # noqa: E402
from intentbev.ops import voxel_embed as jve  # noqa: E402
from intentbev.ops.fused_ln_dense import fused_ln_dense as jax_fused_ln_dense  # noqa: E402
from intentbev.ops.fused_mlp_int8 import fused_mlp_int8 as jax_fused_mlp_int8  # noqa: E402
from intentbev.ops.patch_embed import patch_embed_matmul as jax_patch_embed  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.bev.voxelize import voxelize_packed  # noqa: E402
from intentbev_torch.models import IntentNetViT  # noqa: E402
from intentbev_torch.models import vit as tvit  # noqa: E402
from intentbev_torch.ops import (flash_attention_packed_plain, fused_ln_dense,  # noqa: E402
                                 fused_ln_dense_fn, fused_mlp, fused_mlp_fn, fused_mlp_int8,
                                 int8_dense, patch_embed,
                                 quantize_cols, quantize_linear, quantize_rows,
                                 reference_attention)
from intentbev_torch.parallel import StreamingInferencer  # noqa: E402
from intentbev_torch.synthetic import serving_batch  # noqa: E402
from intentbev_torch.weights import from_flax  # noqa: E402

# the modules (``intentbev.ops`` re-exports functions under these names)
jfm = importlib.import_module("intentbev.ops.fused_mlp")
NUM_CHUNKS = 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mlp_weights(rng, d, hid):
    """JAX-layout f32 weights: w1 [d, hid], b1, w2 [hid, d], b2."""
    return (rng.normal(0, d ** -0.5, (d, hid)).astype(np.float32),
            rng.normal(0, 0.1, hid).astype(np.float32),
            rng.normal(0, hid ** -0.5, (hid, d)).astype(np.float32),
            rng.normal(0, 0.1, d).astype(np.float32))


# -- host copies --------------------------------------------------------------

def _quant_inputs(rng, kind):
    if kind == "normal":
        return rng.normal(0, 1.5, (37, 96)).astype(np.float32)
    # exact halves of the scale: round half to even decides every code
    x = (rng.integers(-126, 126, (37, 96)) + 0.5).astype(np.float32)
    x[:, 0] = 127.0  # absmax 127: the scale is exactly 1
    x[3] = 0.0       # an all-zero row: the eps floor
    return x


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_quantize_matches_jax_bit_for_bit(rng, kind):
    x = _quant_inputs(rng, kind)
    for ours, theirs, arr in ((quantize_rows, jint8.quantize_rows, x),
                              (quantize_cols, jint8.quantize_cols, x.T.copy())):
        q, s = ours(_t(arr))
        qj, sj = theirs(jnp.asarray(arr))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_int8_dense_matches_jax(rng):
    x = rng.normal(0, 1, (50, 96)).astype(np.float32)
    w = rng.normal(0, 0.1, (96, 40)).astype(np.float32)
    b = rng.normal(0, 0.1, 40).astype(np.float32)
    want = np.asarray(jint8.int8_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(int8_dense(_t(x), _t(w), _t(b)).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    q, s = quantize_linear(_t(w.T.copy()))  # the port's Linear layout [out, in]
    qj, sj = jint8.quantize_cols(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj)[0])


# -- kernels: plain versions against the Pallas kernels ------------------------

@pytest.mark.parametrize("gelu", ["erf", "sigmoid"])
def test_fused_mlp_int8_matches_pallas(rng, gelu, monkeypatch):
    monkeypatch.setattr(jfm, "_GELU_MODE", gelu)
    n, d, hid = 300, 128, 512
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    res = rng.normal(0, 1, (n, d)).astype(np.float32)
    w1, b1, w2, b2 = _mlp_weights(rng, d, hid)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused_mlp_int8(*map(jnp.asarray, (x, w1, b1, w2, b2, res))))
    w1q, s1 = quantize_linear(_t(w1.T.copy()))
    w2q, s2 = quantize_linear(_t(w2.T.copy()))
    got = fused_mlp_int8(_t(x), w1q, s1, _t(b1), w2q, s2, _t(b2), _t(res), gelu).numpy()
    mlp = want - res  # the MLP's own output, the scale of its code steps
    assert np.abs(got - want).max() <= 1e-3 * np.abs(mlp).max()


@pytest.mark.parametrize("gelu", ["erf", "sigmoid"])
def test_fused_mlp_matches_pallas(rng, gelu, monkeypatch):
    monkeypatch.setattr(jfm, "_GELU_MODE", gelu)
    n, d, hid = 300, 128, 512
    h = rng.normal(0, 1, (n, d)).astype(np.float32)
    res = rng.normal(0, 1, (n, d)).astype(np.float32)
    w1, b1, w2, b2 = _mlp_weights(rng, d, hid)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfm.fused_mlp(*map(jnp.asarray, (h, w1, b1, w2, b2, res))))
    got = fused_mlp(_t(h), _t(w1.T.copy()), _t(b1), _t(w2.T.copy()), _t(b2), _t(res),
                    gelu_mode=gelu).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("gelu", [None, "erf", "sigmoid"])
def test_fused_ln_dense_matches_pallas(rng, gelu, monkeypatch):
    monkeypatch.setattr(jfm, "_GELU_MODE", gelu or "erf")
    n, d, dout = 300, 128, 192
    x = rng.normal(0.3, 1.5, (n, d)).astype(np.float32)
    g = rng.normal(1, 0.2, d).astype(np.float32)
    b = rng.normal(0, 0.2, d).astype(np.float32)
    w = rng.normal(0, d ** -0.5, (d, dout)).astype(np.float32)  # JAX [in, out]
    bias = rng.normal(0, 0.1, dout).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused_ln_dense(*map(jnp.asarray, (x, g, b, w, bias)),
                                             gelu=gelu is not None))
    got = fused_ln_dense(_t(x), _t(g), _t(b), _t(w.T.copy()), _t(bias),
                         gelu_mode=gelu).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_patch_embed_matches_pallas(rng):
    """C = 290 (P*C = 2320), two samples, a grid of 2 x 5 patch rows."""
    b, h, w, c, d, p = 2, 16, 40, 290, 64, 8
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    kern = rng.normal(0, 0.02, (p, p, c, d)).astype(np.float32)
    bias = rng.normal(0, 0.1, d).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_patch_embed(*map(jnp.asarray, (x, kern, bias)), p))
    got = patch_embed(_t(x), _t(kern), _t(bias), p).numpy()
    assert got.shape == (b, (h // p) * (w // p), d)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


# -- the model ---------------------------------------------------------------

WIDE_GRID = dict(lidar_height_channels=29, lidar_sweeps=10)  # C = 290, the bench's
# name: (ViTBackboneConfig switches, transport, wide lidar grid)
CONFIGS = {
    "int8": (dict(serving_int8=True), "points", False),
    "ln_dense": (dict(fuse_ln_dense=True), "chunks", False),
    "unfused_ln": (dict(use_fused_layernorm=False), "chunks", False),
    "unfused_mlp": (dict(use_fused_mlp=False), "chunks", False),
    "no_chain": (dict(fuse_ln_chain=False), "points", False),
    "patch_embed": (dict(fuse_patch_embed=True), "points", True),
}


def _config(pkg_cfg, switches, wide):
    base = pkg_cfg.tiny_test_config()
    grid = dataclasses.replace(base.grid, **WIDE_GRID) if wide else base.grid
    vit = dataclasses.replace(base.vit, lidar_input_channels=grid.lidar_total_channels,
                              **switches)
    return dataclasses.replace(base, grid=grid, vit=vit)


@pytest.fixture(scope="module")
def variables_by_width():
    """JAX parameters of the tiny model (the tree is the same under every
    switch), narrow and wide lidar input; head kernels scaled up so the
    logits are O(1)."""
    out = {}
    for wide in (False, True):
        cfg = _config(importlib.import_module("intentbev.configs"), {}, wide)
        g = cfg.grid
        bev0 = jnp.zeros((1, g.height_px, g.width_px, g.lidar_total_channels))
        map0 = jnp.zeros((1, g.height_px, g.width_px, g.map_channels))
        v = jax.tree_util.tree_map(np.asarray, build_model(cfg).init(jax.random.key(0),
                                                                     bev0, map0))
        for head in ("det_head", "intention_head"):
            v["params"][head]["conv"]["kernel"] = v["params"][head]["conv"]["kernel"] * 20.0
        out[wide] = v
    return out


def _serve_both(name, variables_by_width, monkeypatch):
    """(port logits, JAX logits, JAX config) for one configuration."""
    monkeypatch.setattr(jfm, "_GELU_MODE", "erf")
    switches, transport, wide = CONFIGS[name]
    jcfg = _config(importlib.import_module("intentbev.configs"), switches, wide)
    cfg = _config(tcfg, switches, wide)
    variables = variables_by_width[wide]
    g = cfg.grid
    pts, valid, mp = serving_batch(g, 2, 600, seed=1)
    inf = StreamingInferencer(cfg, from_flax(variables), "cpu", transport=transport,
                              num_chunks=NUM_CHUNKS)
    if transport == "chunks":
        got = inf.logits(inf.build_chunks(pts, valid), mp)
        lidar = jve.VoxelChunks(*map(jnp.asarray, jve.stack_voxel_chunks([
            jve.build_voxel_chunks(pts[i], valid[i], g, cfg.vit.patch_size,
                                   num_chunks=NUM_CHUNKS, on_overflow="drop")[0]
            for i in range(2)])))
    else:
        got = inf.logits_points(pts, valid, mp)
        lidar = jnp.asarray(voxelize_packed(_t(pts), _t(valid), g).numpy())
    with pltpu.force_tpu_interpret_mode():
        want = build_model(jcfg).apply(
            variables, lidar, decode_map_transport(jnp.asarray(mp), g.map_channels, jnp.float32))
    return [a.numpy() for a in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("name", [n for n in CONFIGS if n != "int8"])
def test_config_matches_jax(name, variables_by_width, monkeypatch):
    got, want = _serve_both(name, variables_by_width, monkeypatch)
    for part, a, b in zip(("cls", "box", "intent"), got, want):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4, err_msg=f"{name} {part}")


def test_int8_config_matches_jax(variables_by_width, monkeypatch):
    """W8A8: the port quantizes the MLPs as the JAX model does (a port
    that serves the f32 MLP instead reads 2.2e-3 here)."""
    got, want = _serve_both("int8", variables_by_width, monkeypatch)
    for part, a, b in zip(("cls", "box", "intent"), got, want):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err < 3e-4, f"int8 {part}: {err}"


def test_from_flax_int8_codes_match_jax(variables_by_width):
    """The codes and scales the int8 model loads are JAX's quantize_cols of
    the f32 parameters (not of a bf16 copy)."""
    cfg = _config(tcfg, dict(serving_int8=True), False)
    variables = variables_by_width[False]
    model = IntentNetViT(cfg.vit, cfg.heads, dtype=torch.bfloat16)
    model.load_state_dict(from_flax(variables))
    for stream in ("vit_lidar", "vit_map"):
        for i, blk in enumerate(getattr(model.backbone, stream).blocks):
            p = variables["params"]["backbone"][stream][f"block{i}"]["mlp"]
            for fc, q_name, s_name in (("fc1", "w1q", "s1"), ("fc2", "w2q", "s2")):
                qj, sj = jint8.quantize_cols(jnp.asarray(p[fc]["kernel"], jnp.float32))
                np.testing.assert_array_equal(getattr(blk.mlp, q_name).numpy(),
                                              np.asarray(qj).T)
                np.testing.assert_array_equal(getattr(blk.mlp, s_name).numpy(),
                                              np.asarray(sj)[0])


# -- training ------------------------------------------------------------------

def _close(got, want, rel, name):
    """max|got - want| <= rel * max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{name}: max|d| {err} vs max|want| {np.abs(want).max()}"


def _leaves(*arrays):
    return [_t(a).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("gated", [False, True])
def test_fused_mlp_backward_matches_jax_grad(rng, gated, monkeypatch):
    """dh, dW1, db1, dW2, db2 and the residual's gradient (dy, ungated)."""
    monkeypatch.setattr(jfm, "_GELU_MODE", "erf")
    n, d, hid = 300, 128, 512
    h, res, dy = (rng.normal(0, 1, (n, d)).astype(np.float32) for _ in range(3))
    w1, b1, w2, b2 = _mlp_weights(rng, d, hid)
    gate = ((rng.uniform(size=n) < 0.7) / 0.9).astype(np.float32) if gated else None

    def loss(*args):
        y = jfm.fused_mlp(*args, gate=None if gate is None else jnp.asarray(gate))
        return jnp.sum(y * jnp.asarray(dy))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, (h, w1, b1, w2, b2, res)))
    leaves = _leaves(h, w1.T.copy(), b1, w2.T.copy(), b2, res)
    y = fused_mlp_fn(*leaves, gate=None if gate is None else _t(gate))
    (y * _t(dy)).sum().backward()
    for name, leaf, w, transpose in zip(("dh", "dw1", "db1", "dw2", "db2", "dres"), leaves,
                                        want, (0, 1, 0, 1, 0, 0)):
        w = np.asarray(w)
        _close(leaf.grad.numpy(), w.T if transpose else w, 1e-4, name)


@pytest.mark.parametrize("gelu", [None, "erf"])
@pytest.mark.parametrize("dout", [3 * 128, 192])  # qkv (3 D) and an adapter width
def test_fused_ln_dense_backward_matches_jax_grad(rng, gelu, dout, monkeypatch):
    """dx, dgamma, dbeta, dW and db over 300 rows (not a multiple of 64)."""
    monkeypatch.setattr(jfm, "_GELU_MODE", "erf")
    n, d = 300, 128
    x = rng.normal(0.3, 1.5, (n, d)).astype(np.float32)
    g = rng.normal(1, 0.2, d).astype(np.float32)
    b = rng.normal(0, 0.2, d).astype(np.float32)
    w = rng.normal(0, d ** -0.5, (d, dout)).astype(np.float32)  # JAX [in, out]
    bias = rng.normal(0, 0.1, dout).astype(np.float32)
    dy = rng.normal(0, 1, (n, dout)).astype(np.float32)

    def loss(*args):
        return jnp.sum(jax_fused_ln_dense(*args, gelu=gelu is not None) * jnp.asarray(dy))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, (x, g, b, w, bias)))
    leaves = _leaves(x, g, b, w.T.copy(), bias)
    (fused_ln_dense_fn(*leaves, gelu_mode=gelu) * _t(dy)).sum().backward()
    for name, leaf, want_g, transpose in zip(("dx", "dgamma", "dbeta", "dw", "db"), leaves,
                                             want, (0, 0, 0, 1, 0)):
        want_g = np.asarray(want_g)
        _close(leaf.grad.numpy(), want_g.T if transpose else want_g, 1e-4, name)


def test_reference_attention_matches_jax_in_bf16(rng):
    """The dense attention of ``use_flash_attention=False`` against the JAX
    one on the same bf16 inputs, masked keys included: both round at the same
    points, so they could differ only where an f32 sum in another order tips a
    value to the neighbouring bf16 (this seed reads 0). The limit, 2**-10 of
    the largest output, is one that the flash path's plain version, which
    rounds q * scale to bf16 first, reaches (3.9e-3 of 1.18 here)."""
    b, t, h, dh, kv_len = 2, 37, 2, 16, 30
    q, k, v = (rng.normal(0, 1, (b, h, t, dh)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_reference_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), kv_len=kv_len).astype(jnp.float32))

    def packed(a):  # [B, H, T, D] -> [B, T, H*D] bf16
        return _t(a.transpose(0, 2, 1, 3).reshape(b, t, h * dh)).bfloat16()

    def unpacked(o):
        return o.float().numpy().reshape(b, t, h, dh).transpose(0, 2, 1, 3)

    got = reference_attention(packed(q), packed(k), packed(v), h, kv_len)
    assert got.dtype == torch.bfloat16
    limit = 2 ** -10 * np.abs(want).max()
    assert np.abs(unpacked(got) - want).max() <= limit
    flash, _ = flash_attention_packed_plain(packed(q), packed(k), packed(v), h, kv_len)
    assert np.abs(unpacked(flash) - want).max() > limit


def _train_config(switches):
    return dataclasses.replace(_config(tcfg, {}, False), vit=dataclasses.replace(
        _config(tcfg, {}, False).vit, **switches))


# name: (switches on tiny_test_config, calls of the structure's entries in one
# training forward of 2 streams x 2 blocks). tiny_test_config has
# use_flash_attention=False; the JAX model's training structure under each.
FLASH = dict(use_flash_attention=True)
REACHED = {
    "default": (FLASH, dict(layernorm_fn=8, flash_attention_fn=4, fused_ln_mlp_fn=4)),
    "no_flash": ({}, dict(layernorm_fn=8, reference_attention=4, fused_ln_mlp_fn=4)),
    "ln_dense": (dict(fuse_ln_dense=True, **FLASH),
                 dict(fused_ln_dense_fn=6, flash_attention_fn=4, fused_ln_mlp_fn=4,
                      layernorm_fn=2)),
    "ln_dense_no_flash": (dict(fuse_ln_dense=True),
                          dict(folded_layernorm=4, reference_attention=4, fused_ln_mlp_fn=4,
                               fused_ln_dense_fn=2, layernorm_fn=2)),
    "unfused_ln": (dict(use_fused_layernorm=False, **FLASH),
                   dict(fast_layernorm=12, flash_attention_fn=4, fused_mlp_fn=4)),
    "unfused_mlp": (dict(use_fused_mlp=False, **FLASH),
                    dict(layernorm_fn=12, flash_attention_fn=4)),
    "unfused_ln_mlp": (dict(use_fused_layernorm=False, use_fused_mlp=False, **FLASH),
                       dict(fast_layernorm=12, flash_attention_fn=4)),
}
COUNTED = ("layernorm_fn", "fast_layernorm", "folded_layernorm", "flash_attention_fn",
           "reference_attention", "fused_ln_mlp_fn", "fused_mlp_fn", "fused_ln_dense_fn")


@pytest.mark.parametrize("name", list(REACHED))
def test_training_forward_follows_the_switches(name, monkeypatch):
    """Which of the model's entries a training forward reaches, counted; the
    serving forward takes the dense attention where the flash path is off."""
    switches, want = REACHED[name]
    calls = collections.Counter()

    def counted(key, fn):
        def call(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return call

    for key in COUNTED:
        monkeypatch.setattr(tvit, key, counted(key, getattr(tvit, key)), raising=False)
    cfg = _train_config(switches)
    model = IntentNetViT(cfg.vit, cfg.heads)
    model.reset_parameters(torch.Generator().manual_seed(0))
    g = cfg.grid
    bev = torch.zeros(2, g.height_px, g.width_px, g.lidar_total_channels)
    mp = torch.zeros(2, g.height_px, g.width_px, g.map_channels)
    out = model.train()(bev, mp, torch.Generator().manual_seed(1))
    assert dict(calls) == want
    sum(o.sum() for o in out).backward()
    calls.clear()
    with torch.no_grad():
        model.eval()(bev, mp)
    assert calls["reference_attention"] == want.get("reference_attention", 0)


@pytest.mark.parametrize("switches", [dict(serving_int8=True)])
def test_training_raises_where_the_backward_is_not_ported(switches):
    cfg = _config(tcfg, switches, False)
    model = IntentNetViT(cfg.vit, cfg.heads).train()
    g = cfg.grid
    bev = torch.zeros(1, g.height_px, g.width_px, g.lidar_total_channels)
    with pytest.raises(NotImplementedError):
        model(bev, torch.zeros(1, g.height_px, g.width_px, g.map_channels))


def test_training_takes_only_the_erf_gelu():
    """The backwards pair the forward with the erf GELU's derivative."""
    cfg = _config(tcfg, dict(fuse_ln_dense=True), False)
    model = IntentNetViT(cfg.vit, cfg.heads, gelu="sigmoid").train()
    g = cfg.grid
    bev = torch.zeros(1, g.height_px, g.width_px, g.lidar_total_channels)
    with pytest.raises(ValueError):
        model(bev, torch.zeros(1, g.height_px, g.width_px, g.map_channels))
    x = torch.zeros(3, 384)
    with pytest.raises(ValueError):
        fused_ln_dense_fn(x, torch.ones(384), torch.zeros(384), torch.zeros(64, 384),
                          torch.zeros(64), gelu_mode="sigmoid")
