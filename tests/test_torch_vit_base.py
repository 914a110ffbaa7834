"""ViT-B's width (D=768, 12 heads of 64, hidden 3072), the width
``intentbev/import_torch.py:235`` reads for a timm ``vit_base`` checkpoint,
against the JAX package on the CPU.

The kernels of ViT-B's serving path take this width on the card (rows 1,
4 and 5; ``csrc/fused_ln_mlp.cu``'s ``ln_mlp_wide_kernel`` for row 4). Their
plain versions, the CPU path and the card's oracle, are held here against
JAX's Pallas kernels in interpret mode, in bf16, compiled with
``xla_allow_excess_precision`` off, as ``tests/test_torch_ln_mlp_fwd.py``
and ``tests/test_torch_patch_embed.py`` hold them at 384 and 192: 128 rows
from a numpy seed (JAX pads them to its row blocks) for row 4 (``_fwd_ln_out``,
both GELUs) and row 5 (``_fwd_infer``), and row 1 (``voxel_embed_tokens``)
on chunks built there. The reading is the share of the outputs' elements
that differ, limit ``SHARE`` = 1 % (f32 summation order tips a few values
to the neighbouring bf16); each control moves one rounding point and must
exceed it (row 4: h kept in f32 before fc2; row 5: the variance over N-1;
row 1: the cell value kept in f32 before its product).

Then a depth-1 ViT-B on the tiny grid, initialised by JAX and carried by
``from_flax``, serves as ``tests/test_torch_slice.py`` serves the tiny
config: logits to 1e-4 (f32, summation order), the same Detections; and so
under each serving variant of ``VIT_SERVING_VARIANTS`` (A ``serving_int8``,
B ``fuse_ln_dense``, C ``use_fused_layernorm=False``, D
``fuse_patch_embed``: rows 17, 14, 13 and 15 at D=768 on the card) over the
variant's transport, D on the bench's 290 lidar channels, as
``tests/test_torch_variants.py`` serves the tiny config. A's logits are
read relative to their scale, limit ``INT8_LOGITS``: JAX's model takes the
unfused int8 pair with the exact erf, and the two sides' f32 block inputs
(LayerNorm, attention) differ in their last bits, so the codes of the 768
values of a row of x and the 3072 of h flip where such a difference
straddles a rounding boundary (3e-4 holds the tiny config's 32 and 128).
Sound readings 6.8e-4-8.7e-4; the control, the port serving the bf16 MLP
without ``serving_int8``, reads 1.0e-2-1.2e-2 and must exceed the limit.
The codes A loads through ``from_flax`` are JAX's ``quantize_cols`` of the
f32 parameters, bit for bit, at this width.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev.bev.rasterize import decode_map_transport  # noqa: E402
from intentbev.boxes.anchors import generate_anchors  # noqa: E402
from intentbev.boxes.nms import batched_postprocess  # noqa: E402
from intentbev.models import build_model  # noqa: E402
from intentbev.ops import int8 as jint8  # noqa: E402
from intentbev.ops import voxel_embed as jve  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.bev.voxelize import voxelize_packed  # noqa: E402
from intentbev_torch.models import IntentNetViT  # noqa: E402
from intentbev_torch.ops import voxel_embed as tve  # noqa: E402
from intentbev_torch.parallel import StreamingInferencer  # noqa: E402
from intentbev_torch.parallel.inference import VIT_SERVING_VARIANTS  # noqa: E402
from intentbev_torch.synthetic import serving_batch  # noqa: E402
from intentbev_torch.weights import from_flax  # noqa: E402
from intentbev_torch.ops.fused_ln_mlp import fused_ln_mlp_plain, gelu  # noqa: E402
from intentbev_torch.ops.layernorm import layernorm_plain  # noqa: E402
from test_torch_patch_embed import (C, HW, P, _bf16, _case, _compile, _to_torch,  # noqa: E402
                                    _unrounded)
from test_torch_slice import NUM_CHUNKS, check_from_flax, check_serving, serve_setup  # noqa: E402
from test_torch_variants import WIDE_GRID  # noqa: E402

jfl = importlib.import_module("intentbev.ops.fused_ln_mlp")
jfm = importlib.import_module("intentbev.ops.fused_mlp")
jln = importlib.import_module("intentbev.ops.layernorm")

D, HIDDEN, N = 768, 3072, 128  # ViT-B's width and MLP; rows of the row-kernel cases
EPS = 1e-6
SHARE = 1e-2  # limit on the share of an output's elements that differ
VIT_B = dict(embed_dim=D, num_heads=12, depth=1)
INT8_LOGITS = 3e-3  # limit on A's logits' max |d| over their largest value


def _share(got, want):
    return float(np.mean(np.asarray(got) != np.asarray(want)))


def _rows_inputs(seed):
    """bf16-exact x and weights (PyTorch's [out, in] layout), f32 LN
    parameters and biases."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(0, 1, (N, D)))
    ln = [rng.normal(1 - i % 2, 0.2, D).astype(np.float32) for i in range(4)]
    w1, w2 = _bf16(rng.normal(0, D ** -0.5, (HIDDEN, D))), _bf16(rng.normal(0, HIDDEN ** -0.5,
                                                                            (D, HIDDEN)))
    b1, b2 = (rng.normal(0, 0.1, n).astype(np.float32) for n in (HIDDEN, D))
    return x, ln, w1, b1, w2, b2


@pytest.fixture(scope="module")
def jax_ln_out():
    """JAX's ``_fwd_ln_out`` (y, yn) by GELU, f32 [N, D] each."""
    return {}


def _jax_ln_out(runs, gelu_mode, monkeypatch):
    if gelu_mode not in runs:
        monkeypatch.setattr(jfm, "_GELU_MODE", gelu_mode)
        x, ln, w1, b1, w2, b2 = _rows_inputs(0)
        n_pad = jfl._pad_rows(N)
        xj = jnp.asarray(np.pad(x, ((0, n_pad - N), (0, 0))), jnp.bfloat16)
        gate = jnp.ones((n_pad, 1), jnp.float32)
        out = _compile(lambda *t: jfl._fwd_ln_out(*t, EPS), xj, *map(jnp.asarray, ln[:2]),
                       jnp.asarray(w1.T, jnp.bfloat16), jnp.asarray(b1),
                       jnp.asarray(w2.T, jnp.bfloat16), jnp.asarray(b2), gate,
                       *map(jnp.asarray, ln[2:]))
        runs[gelu_mode] = [np.asarray(o.astype(jnp.float32))[:N] for o in out]
    return runs[gelu_mode]


def _port_ln_out(gelu_mode, fault=None):
    """The plain row 4 (y, yn) in bf16, or with ``fault="h_f32"`` h kept in
    f32 before fc2."""
    x, ln, w1, b1, w2, b2 = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                             else [torch.from_numpy(p) for p in a] for a in _rows_inputs(0))
    if fault is None:
        out = fused_ln_mlp_plain(x.bfloat16(), *ln[:2], w1.bfloat16(), b1, w2.bfloat16(), b2,
                                 *ln[2:], EPS, gelu_mode)
        return [o.float().numpy() for o in out]
    xn = layernorm_plain(x, *ln[:2], EPS).bfloat16().float()
    y = gelu(xn @ w1.t() + b1, gelu_mode) @ w2.t() + b2 + x
    return [y.bfloat16().float().numpy(),
            layernorm_plain(y, *ln[2:], EPS).bfloat16().float().numpy()]


@pytest.mark.parametrize("gelu_mode", ["erf", "sigmoid"])
def test_row4_serving_tail_matches_jax(jax_ln_out, monkeypatch, gelu_mode):
    """``fused_ln_mlp_plain`` (y, yn) at D=768, hidden 3072, against
    ``_fwd_ln_out``."""
    want = _jax_ln_out(jax_ln_out, gelu_mode, monkeypatch)
    shares = [_share(g, w) for g, w in zip(_port_ln_out(gelu_mode), want)]
    print(f"row 4 D=768 {gelu_mode}: shares {shares}")
    assert max(shares) <= SHARE, shares


def test_row4_control_exceeds_the_limit(jax_ln_out, monkeypatch):
    """h kept in f32 before fc2 moves y and yn past the limit."""
    want = _jax_ln_out(jax_ln_out, "sigmoid", monkeypatch)
    shares = [_share(g, w) for g, w in zip(_port_ln_out("sigmoid", "h_f32"), want)]
    assert min(shares) > SHARE, shares


def test_row5_layernorm_matches_jax():
    """``layernorm_plain`` at D=768 against ``_fwd_infer`` in bf16; control:
    the variance over N-1."""
    x, ln, *_ = _rows_inputs(1)
    n_pad = jln._pad_rows(N)
    want = _compile(lambda *t: jln._fwd_infer(*t, EPS),
                    jnp.asarray(np.pad(x, ((0, n_pad - N), (0, 0))), jnp.bfloat16),
                    jnp.asarray(ln[0]), jnp.asarray(ln[1]))
    want = np.asarray(want.astype(jnp.float32))[:N]
    xt, g, b = torch.from_numpy(x).bfloat16(), torch.from_numpy(ln[0]), torch.from_numpy(ln[1])
    sound = _share(layernorm_plain(xt, g, b, EPS).float().numpy(), want)
    xf = xt.float()
    ctrl = ((xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(xf.var(-1, keepdim=True) + EPS)
            * g + b).bfloat16().float().numpy()
    print(f"row 5 D=768: share {sound:.4%}, control {_share(ctrl, want):.4%}")
    assert sound < SHARE
    assert _share(ctrl, want) >= SHARE


def test_row1_voxel_embed_matches_jax():
    """``voxel_embed_tokens_plain`` at D=768 against JAX's kernel on two
    bands of ~1500 and 1200 cells (one channel out of range; the second
    sample empty), over the tokens that take a hit; control: the cell value
    kept in f32 before its product."""
    rng = np.random.default_rng(1)
    chunks = _case("spread", rng)
    kern = _bf16(rng.normal(0, 0.05, (P, P, C, D)))
    bias = rng.normal(0, 0.1, D).astype(np.float32)
    want = _compile(lambda ch, k, b: jve.voxel_embed_tokens(ch, k, b, P, HW),
                    jve.VoxelChunks(*(jnp.asarray(a) for a in chunks)),
                    jnp.asarray(kern, jnp.bfloat16), jnp.asarray(bias))
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    ct = _to_torch(chunks)
    kt, bt = torch.from_numpy(kern).bfloat16(), torch.from_numpy(bias)
    got = tve.voxel_embed_tokens_plain(ct, kt, bt, P, HW)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # read over the tokens with a hit (the others are the bias on every side)
    hit = tve.voxel_hits_plain(ct, C, P, HW).offsets.diff(dim=-1).reshape(got.shape[0], -1) > 0
    sound = _share(got.float()[hit].numpy(), want[hit].numpy())
    ctrl = _share(_unrounded(ct, kt, bt).float()[hit].numpy(), want[hit].numpy())
    print(f"row 1 D=768: share {sound:.4%} over {int(hit.sum())} tokens, control {ctrl:.4%}")
    assert sound < SHARE
    assert ctrl >= SHARE


@pytest.fixture(scope="module")
def vit_b_setup():
    """``serve_setup`` with the JAX model applied under one ``jax.jit``
    (applied op by op at this width, an op dispatched while an interpreted
    kernel's store callback runs has left both waiting) and the head
    kernels as initialised: scaled by 20 as for the narrow widths, every
    score of the 768-wide features saturates to 1 in f32 and the top-k
    order is a tie."""
    base = jcfg.tiny_test_config()
    return serve_setup(dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, use_flash_attention=True, **VIT_B)), jit=True, head_scale=1.0)


def test_vit_b_from_flax_covers_the_model(vit_b_setup):
    check_from_flax(*vit_b_setup[:2])


def _variant_config(pkg_cfg, switches, wide):
    """The depth-1 ViT-B of ``vit_b_setup`` under ``switches``, on the bench's
    290 lidar channels with ``wide`` (the patch-embed kernel takes >= 128)."""
    base = pkg_cfg.tiny_test_config()
    grid = dataclasses.replace(base.grid, **WIDE_GRID) if wide else base.grid
    return dataclasses.replace(base, grid=grid, vit=dataclasses.replace(
        base.vit, lidar_input_channels=grid.lidar_total_channels, use_flash_attention=True,
        **VIT_B, **switches))


@pytest.fixture(scope="module")
def wide_variables():
    """JAX parameters of the depth-1 ViT-B on 290 lidar channels (D's),
    head kernels as initialised (``vit_b_setup``'s reason)."""
    cfg = _variant_config(jcfg, {}, True)
    g = cfg.grid
    bev0 = jnp.zeros((1, g.height_px, g.width_px, g.lidar_total_channels))
    map0 = jnp.zeros((1, g.height_px, g.width_px, g.map_channels))
    return jax.tree_util.tree_map(np.asarray, build_model(cfg).init(jax.random.key(0), bev0,
                                                                    map0))


def _check_variant(name, vit_b_setup, request, monkeypatch):
    """Serving variant ``name``: the port's StreamingInferencer over the
    variant's transport against the JAX model's logits and Detections."""
    monkeypatch.setattr(jfm, "_GELU_MODE", "erf")  # the port serves the erf GELU here
    switches, transport = VIT_SERVING_VARIANTS[name]
    wide = "fuse_patch_embed" in switches
    jc, tc = (_variant_config(c, switches, wide) for c in (jcfg, tcfg))
    variables = request.getfixturevalue("wide_variables") if wide else vit_b_setup[1]
    g = tc.grid
    pts, valid, mp = serving_batch(g, 2, 600, seed=1)
    inf = StreamingInferencer(tc, from_flax(variables), "cpu", transport=transport,
                              num_chunks=NUM_CHUNKS)
    if transport == "chunks":
        got = inf.logits(inf.build_chunks(pts, valid), mp)
        lidar = jve.VoxelChunks(*map(jnp.asarray, jve.stack_voxel_chunks([
            jve.build_voxel_chunks(pts[i], valid[i], g, tc.vit.patch_size,
                                   num_chunks=NUM_CHUNKS, on_overflow="drop")[0]
            for i in range(2)])))
    else:
        got = inf.logits_points(pts, valid, mp)
        lidar = jnp.asarray(voxelize_packed(torch.from_numpy(pts), torch.from_numpy(valid),
                                            g).numpy())
    args = (variables, lidar, decode_map_transport(jnp.asarray(mp), g.map_channels,
                                                   jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(build_model(jc).apply)(*args)

    def scaled_err(a, b):
        return float(np.abs(a.numpy() - np.asarray(b)).max() / np.abs(np.asarray(b)).max())

    if name == "int8":  # relative to the logits' scale (the module docstring)
        ctrl = StreamingInferencer(_variant_config(tcfg, {}, False), from_flax(variables), "cpu",
                                   transport=transport).logits_points(pts, valid, mp)
        sound = [scaled_err(a, b) for a, b in zip(got, want)]
        control = [scaled_err(a, b) for a, b in zip(ctrl, want)]
        print(f"ViT-B int8 logits: {sound} of their scale, control (no int8) {control}")
        assert max(sound) < INT8_LOGITS, sound
        assert min(control) >= INT8_LOGITS, control
    else:
        for part, a, b in zip(("cls", "box", "intent"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4,
                                       err_msg=f"{name} {part}")
    ev = tc.eval
    want_det = batched_postprocess(
        *want, jnp.asarray(generate_anchors(g, jc.anchors)),
        confidence_threshold=ev.confidence_threshold, nms_iou_threshold=ev.nms_iou_threshold,
        max_pre_nms=ev.max_pre_nms, max_detections=ev.max_detections)
    det = inf(pts, valid, mp)
    for field in ("num_conf", "num_kept"):
        np.testing.assert_array_equal(getattr(det, field), np.asarray(getattr(want_det, field)),
                                      err_msg=f"{name} {field}")
    if name == "int8":  # flipped codes may swap two detections of near-equal scores
        np.testing.assert_array_equal(np.sort(det.intentions * det.valid, -1), np.sort(
            np.asarray(want_det.intentions) * np.asarray(want_det.valid), -1))
        return
    for field in ("valid", "intentions"):
        np.testing.assert_array_equal(getattr(det, field), np.asarray(getattr(want_det, field)),
                                      err_msg=f"{name} {field}")
    np.testing.assert_allclose(det.boxes_xywha, np.asarray(want_det.boxes_xywha), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("variant", ["default", *VIT_SERVING_VARIANTS])
def test_vit_b_serves_like_jax(vit_b_setup, request, monkeypatch, variant):
    """The port's StreamingInferencer against the JAX model's logits (12
    heads of 64 pair into the packed attention on both sides) and
    Detections, by default and under each serving variant."""
    cfg = vit_b_setup[0]
    assert (cfg.vit.embed_dim, cfg.vit.num_heads, cfg.vit.depth) == (768, 12, 1)
    if variant == "default":
        check_serving(*vit_b_setup, box_rtol=1e-5)
    else:
        _check_variant(variant, vit_b_setup, request, monkeypatch)


def test_vit_b_int8_codes_match_jax(vit_b_setup):
    """The codes and scales ViT-B loads under ``serving_int8`` (D=768,
    hidden 3072) are JAX's quantize_cols of the f32 parameters."""
    cfg = _variant_config(tcfg, dict(serving_int8=True), False)
    variables = vit_b_setup[1]
    model = IntentNetViT(cfg.vit, cfg.heads, dtype=torch.bfloat16)
    model.load_state_dict(from_flax(variables))
    for stream in ("vit_lidar", "vit_map"):
        (blk,) = getattr(model.backbone, stream).blocks
        p = variables["params"]["backbone"][stream]["block0"]["mlp"]
        for fc, q_name, s_name in (("fc1", "w1q", "s1"), ("fc2", "w2q", "s2")):
            qj, sj = jint8.quantize_cols(jnp.asarray(p[fc]["kernel"], jnp.float32))
            assert getattr(blk.mlp, q_name).shape == np.asarray(qj).T.shape
            np.testing.assert_array_equal(getattr(blk.mlp, q_name).numpy(), np.asarray(qj).T)
            np.testing.assert_array_equal(getattr(blk.mlp, s_name).numpy(), np.asarray(sj)[0])
