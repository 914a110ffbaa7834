"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. On a machine
with an H100 (which has no JAX, so the suite's conftest cannot load):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Readings are relative L2 errors, ||kernel - plain|| / ||plain||, in bf16:
both sides round the same f32 quantities at the same points, so a sound
kernel differs only where f32 summation order tips a value to the
neighbouring bf16. Each limit (those of ``chip_smoke.py``) lies between that
noise and the reading of a control, the plain version with one plausible
fault, and each test also checks that the control reaches the limit.
The training kernels (LayerNorm forward/backward, LN+MLP forward with a
drop-path gate and backward, flash backward) run at small and at the
training step's full-width shapes. The dense BEV fill is exact: its reading
is the count of elements that differ from the plain version, which must be
0, and its control (the last chunk of each band skipped) must differ. The
kernels of the other serving configurations (W8A8 MLP, MLP without LN,
LN + dense, patch embed) run at small and at main-path shapes, and so do
the training entries of two of them: the MLP without LN (forward with a
drop-path gate, backward with and without one) and the LN + dense backward
(qkv without GELU, adapter with the erf GELU). The row kernels that the
ViT-Ti width runs (LayerNorm, LN+MLP, voxel embed) run at D=384 and D=192,
and the BHTD attention (forward and backward) at head dims 64 and 32, on
contiguous [B, H, T, D] tensors and on the views of a qkv projection
output, at small and at ViT-Ti's main-path shapes. The packed attention's
three backward forms (fused, split, chunked: row 11) run at 6 heads of 64
and at 12 heads of 32, with the packed forward at head dim 32. The library
ops of ``ops.experimental`` (rows 18 and 19: the int8 attention, the
residual projection forward and backward) run at small and at the
attention sublayer's shapes, and raise on what they are not built for.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

from intentbev_torch.configs import GridConfig, default_vit_config  # noqa: E402
from intentbev_torch.ops import (  # noqa: E402
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_fwd_plain, flash_attention_fn,
    fused_ln_dense, fused_ln_dense_bwd, fused_ln_dense_bwd_plain, fused_ln_dense_plain,
    fused_mlp, fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_int8, fused_mlp_int8_plain,
    fused_mlp_plain, fused_mlp_train, patch_embed, patch_embed_plain, quantize_linear,
    quantize_rows,
    flash_attention_packed, flash_attention_packed_bwd, flash_attention_packed_bwd_plain,
    flash_attention_packed_plain, fused_ln_mlp, fused_ln_mlp_bwd, fused_ln_mlp_bwd_plain,
    fused_ln_mlp_plain, fused_ln_mlp_train, fused_ln_mlp_train_plain, launches, layernorm,
    layernorm_bwd, layernorm_bwd_plain, layernorm_plain, layernorm_train,
    layernorm_train_plain, reset_launch_counts, voxel_embed_tokens,
    voxel_embed_tokens_plain, voxel_fill_bev, voxel_fill_bev_plain)
from intentbev_torch.ops.experimental import (  # noqa: E402
    flash_attention_packed_int8, flash_attention_packed_int8_plain, fused_dense_residual,
    fused_proj_bwd, fused_proj_bwd_plain, fused_proj_fwd, fused_proj_fwd_plain)
from intentbev_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_packed_layout, heads_view)
from intentbev_torch.ops.voxel_embed import (  # noqa: E402
    chunks_to_device, decode_chunk_transport)
from intentbev_torch.parallel.inference import build_chunk_transport  # noqa: E402
from intentbev_torch.synthetic import serving_batch  # noqa: E402

pytestmark = pytest.mark.gpu

D = 384
WIDTHS = [384, 192]  # ViT-S and ViT-Ti
MAIN_ROWS = 8 * 4501  # flagship batch 8 x 4501 tokens


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _randn(shape, std, seed, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=_gen(seed), device="cuda") * std).to(dtype)


def _rel(got, want):
    assert torch.isfinite(got).all()
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def _layernorm_unbiased(x, g, b, eps=1e-6):  # control fault: variance over N-1
    xf = x.float()
    var = xf.var(-1, keepdim=True, correction=1)
    return ((xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", [10, MAIN_ROWS])
def test_layernorm(dev, rows, d):
    x = _randn((rows, d), 2.0, 0) + 0.5
    g = _randn((d,), 0.3, 1, torch.float32) + 1
    b = _randn((d,), 0.3, 2, torch.float32)
    got = layernorm(x, g, b)
    assert _rel(got, layernorm_plain(x, g, b)) < 3e-4
    assert _rel(got, _layernorm_unbiased(x, g, b)) >= 3e-4


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("gelu", ["erf", "sigmoid"])
@pytest.mark.parametrize("rows", [100, MAIN_ROWS])
def test_fused_ln_mlp(dev, rows, gelu, d):
    x = _randn((rows, d), 1.0, 0)
    ln = [_randn((d,), 0.2, s, torch.float32) + (1 - s % 2) for s in (1, 2, 3, 4)]
    w1 = _randn((4 * d, d), d ** -0.5, 5)
    b1 = _randn((4 * d,), 0.1, 6, torch.float32)
    w2 = _randn((d, 4 * d), (4 * d) ** -0.5, 7)
    b2 = _randn((d,), 0.1, 8, torch.float32)
    args = (x, ln[0], ln[1], w1, b1, w2, b2, ln[2], ln[3])
    y, yn = fused_ln_mlp(*args, gelu_mode=gelu)
    y_ref, yn_ref = fused_ln_mlp_plain(*args, gelu_mode=gelu)
    assert _rel(y, y_ref) < 1e-3
    assert _rel(yn, yn_ref) < 1e-3
    other = "sigmoid" if gelu == "erf" else "erf"  # control: the other GELU
    y_ctl, yn_ctl = fused_ln_mlp_plain(*args, gelu_mode=other)
    assert _rel(y, y_ctl) >= 1e-3 and _rel(yn, yn_ctl) >= 1e-3


@pytest.mark.parametrize("b,t,seq_len", [(1, 300, 250), (2, 130, 130), (8, 4501, 4501)])
def test_flash_packed_on_qkv_slices(dev, b, t, seq_len):
    qkv = _randn((b, t, 3 * D), 1.0, 0)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    o, lse = flash_attention_packed(q, k, v, 6, seq_len)
    o_ref, lse_ref = flash_attention_packed_plain(q, k, v, 6, seq_len)
    assert o.shape == (b, t, D) and lse.shape == (b, 6, t)
    assert _rel(o, o_ref) < 1e-2
    assert float((lse - lse_ref).abs().max()) < 1e-3
    # control: the keys of the last partial 64-key tile (or the last tile) masked
    o_ctl, _ = flash_attention_packed_plain(q, k, v, 6, (seq_len - 1) // 64 * 64)
    assert _rel(o, o_ctl) >= 1e-2


def _chunks(grid, batch, points, seed, num_chunks):
    pts, valid, _ = serving_batch(grid, batch, points, seed)
    host = build_chunk_transport(pts, valid, grid, 8, num_chunks)
    return decode_chunk_transport(chunks_to_device(host, "cuda"))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("size", ["small", "main"])
def test_voxel_embed(dev, size, d):
    if size == "small":
        grid = GridConfig(height_px=80, width_px=96, lidar_height_channels=4,
                          lidar_sweeps=2)
        chunks = _chunks(grid, 2, 3000, 0, 64)
    else:
        grid = default_vit_config().grid
        chunks = _chunks(grid, 8, 16384, 0, 512)
    c = grid.lidar_total_channels
    w = _randn((8, 8, c, d), 0.05, 1)
    bias = _randn((d,), 0.1, 2, torch.float32)
    hw = (grid.height_px, grid.width_px)
    got = voxel_embed_tokens(chunks, w, bias, 8, hw)
    want = voxel_embed_tokens_plain(chunks, w, bias, 8, hw)
    assert got.shape == ((chunks.wid.shape[0], (hw[0] // 8) * (hw[1] // 8), d))
    assert _rel(got, want) < 3e-3
    skipped = chunks._replace(count=(chunks.count - 1).clamp(min=0))  # control
    assert _rel(got, voxel_embed_tokens_plain(skipped, w, bias, 8, hw)) >= 3e-3


def test_voxel_embed_skips_out_of_range_channel(dev):
    grid = GridConfig(height_px=80, width_px=96, lidar_height_channels=4, lidar_sweeps=2)
    chunks = _chunks(grid, 1, 500, 3, 64)
    c = grid.lidar_total_channels
    ch = chunks.ch.clone()
    ch[0, 0, 0, 0, 0] = c  # must be dropped, not read past W
    chunks = chunks._replace(ch=ch)
    w = _randn((8, 8, c, D), 0.05, 1)
    bias = torch.zeros(D, device="cuda")
    hw = (grid.height_px, grid.width_px)
    got = voxel_embed_tokens(chunks, w, bias, 8, hw)
    assert _rel(got, voxel_embed_tokens_plain(chunks, w, bias, 8, hw)) < 3e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size", ["small", "main"])
def test_voxel_fill(dev, size, dtype):
    if size == "small":  # bands of one patch row
        grid = GridConfig(height_px=64, width_px=96, lidar_height_channels=4,
                          lidar_sweeps=2)
        chunks = _chunks(grid, 2, 3000, 0, 64)
    else:  # bands of five patch rows, serving capacity
        grid = default_vit_config().grid
        chunks = _chunks(grid, 8, 16384, 0, 512)
    c, hw = grid.lidar_total_channels, (grid.height_px, grid.width_px)
    reset_launch_counts()
    got = voxel_fill_bev(chunks, hw, c, 8, dtype)
    assert launches["voxel_fill"] == 1
    want = voxel_fill_bev_plain(chunks, hw, c, 8, dtype)
    assert got.dtype == dtype and got.shape == (chunks.wid.shape[0], *hw, c)
    assert int((got != want).sum()) == 0 and int((want != 0).sum()) > 1000
    skipped = chunks._replace(count=(chunks.count - 1).clamp(min=0))  # control
    assert int((got != voxel_fill_bev_plain(skipped, hw, c, 8, dtype)).sum()) > 0


def test_voxel_fill_drops_out_of_range_channel(dev):
    grid = GridConfig(height_px=64, width_px=96, lidar_height_channels=4, lidar_sweeps=2)
    chunks = _chunks(grid, 1, 500, 3, 64)
    c, hw = grid.lidar_total_channels, (grid.height_px, grid.width_px)
    ch = chunks.ch.clone()
    ch[0, 0, 0, 0, :2] = torch.tensor([c, -1])  # must be dropped, not written
    chunks = chunks._replace(ch=ch)
    got = voxel_fill_bev(chunks, hw, c, 8)
    assert int((got != voxel_fill_bev_plain(chunks, hw, c, 8)).sum()) == 0


def test_launch_counts(dev):
    x = _randn((64, D), 1.0, 0)
    g, b = torch.ones(D, device="cuda"), torch.zeros(D, device="cuda")
    reset_launch_counts()
    layernorm(x, g, b)
    layernorm(x, g, b)
    layernorm_plain(x, g, b)
    assert launches["layernorm"] == 2
    assert launches["flash_packed"] == 0


def test_cuda_tensors_never_take_the_plain_version(dev):
    x = torch.randn(8, 32, device="cuda", dtype=torch.bfloat16)  # D not in (192, 384)
    with pytest.raises(ValueError):
        layernorm(x, torch.ones(32, device="cuda"), torch.zeros(32, device="cuda"))
    with pytest.raises(ValueError):  # f32 input
        layernorm(x.float(), torch.ones(32, device="cuda"), torch.zeros(32, device="cuda"))
    q = torch.randn(1, 3, 64, 48, device="cuda", dtype=torch.bfloat16)  # head dim 48
    with pytest.raises(ValueError):
        flash_attention_fwd(q, q, q)


# Limits of the training kernels (those of chip_smoke.py; PERF.md has the
# sound and control readings they sit between).
LN_BWD_LIMIT = 1e-3
MLP_BWD_LIMIT = 2e-3
FLASH_BWD_LIMIT = 1e-2


def _rels(got, want):
    return [_rel(a, b) for a, b in zip(got, want)]


def layernorm_bwd_no_m2(dy, xhat, inv, g):
    """Control fault: the LN backward without its mean(dyg * xhat) term."""
    dyg = dy.float() * g
    dx = inv[..., None] * (dyg - dyg.mean(-1, keepdim=True))
    return dx.to(dy.dtype), (dy.float() * xhat.float()).sum(0), dy.float().sum(0)


def _gate(rows_b, t, seed):
    """Per-sample drop-path gate (0 or 1/0.9) broadcast over t tokens."""
    keep = torch.rand(rows_b, generator=_gen(seed), device="cuda") < 0.7
    return (keep.float() / 0.9)[:, None].expand(rows_b, t).contiguous()


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", [10, MAIN_ROWS])
def test_layernorm_train_and_bwd(dev, rows, d):
    x = _randn((rows, d), 2.0, 0) + 0.5
    g = _randn((d,), 0.3, 1, torch.float32) + 1
    b = _randn((d,), 0.3, 2, torch.float32)
    y, xhat, inv = layernorm_train(x, g, b)
    y_p, xhat_p, inv_p = layernorm_train_plain(x, g, b)
    assert _rel(y, y_p) < 3e-4 and _rel(xhat, xhat_p) < 3e-4 and _rel(inv, inv_p) < 1e-5
    assert _rel(y, _layernorm_unbiased(x, g, b)) >= 3e-4
    dy = _randn((rows, d), 1.0, 3)
    got = layernorm_bwd(dy, xhat, inv, g)
    want = layernorm_bwd_plain(dy, xhat, inv, g)
    assert max(_rels(got, want)) < LN_BWD_LIMIT
    assert max(_rels(got, layernorm_bwd_no_m2(dy, xhat, inv, g))) >= LN_BWD_LIMIT


def _mlp_params(d=D):
    ln = [_randn((d,), 0.2, s, torch.float32) + (1 - s % 2) for s in (1, 2)]
    w1 = _randn((4 * d, d), d ** -0.5, 5)
    b1 = _randn((4 * d,), 0.1, 6, torch.float32)
    w2 = _randn((d, 4 * d), (4 * d) ** -0.5, 7)
    b2 = _randn((d,), 0.1, 8, torch.float32)
    return ln[0], ln[1], w1, b1, w2, b2


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("b,t", [(2, 50), (8, 4501)])
def test_fused_ln_mlp_train_and_bwd(dev, b, t, d):
    x = _randn((b, t, d), 1.0, 0)
    gamma, beta, w1, b1, w2, b2 = _mlp_params(d)
    gate = _gate(b, t, 9)
    gate[0] = 0.0  # one sample dropped
    y = fused_ln_mlp_train(x, gamma, beta, w1, b1, w2, b2, gate)
    assert _rel(y, fused_ln_mlp_train_plain(x, gamma, beta, w1, b1, w2, b2, gate)) < 1e-3
    # control: the gate ignored
    assert _rel(y, fused_ln_mlp_train_plain(x, gamma, beta, w1, b1, w2, b2)) >= 1e-3
    dy = _randn((b, t, d), 1.0, 10)
    got = fused_ln_mlp_bwd(x, gamma, beta, w1, b1, w2, gate, dy)
    want = fused_ln_mlp_bwd_plain(x, gamma, beta, w1, b1, w2, gate, dy)
    assert max(_rels(got, want)) < MLP_BWD_LIMIT, _rels(got, want)
    ctrl = fused_ln_mlp_bwd_plain(x, gamma, beta, w1, b1, w2, None, dy)
    assert max(_rels(got, ctrl)) >= MLP_BWD_LIMIT


@pytest.mark.parametrize("b,t,seq_len", [(1, 300, 250), (2, 130, 130), (8, 4501, 4501)])
def test_flash_bwd_on_qkv_slices(dev, b, t, seq_len):
    qkv = _randn((b, t, 3 * D), 1.0, 0)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    o, lse = flash_attention_packed(q, k, v, 6, seq_len)
    do = _randn((b, t, D), 1.0, 1)
    got = flash_attention_packed_bwd(q, k, v, o, lse, do, 6, seq_len)
    want = flash_attention_packed_bwd_plain(q, k, v, o, lse, do, 6, seq_len)
    parts = [slice(j * D, (j + 1) * D) for j in range(3)]
    rels = [_rel(got[..., p], want[..., p]) for p in parts]
    assert max(rels) < FLASH_BWD_LIMIT, rels
    assert not got[:, seq_len:, D:].any()  # masked keys: dk = dv = 0
    # control: delta = rowsum(dO * O) left out (O = 0)
    ctrl = flash_attention_packed_bwd_plain(q, k, v, torch.zeros_like(o), lse, do, 6, seq_len)
    assert max(_rel(got[..., p], ctrl[..., p]) for p in parts) >= FLASH_BWD_LIMIT


# The BHTD attention (limits those of the packed kernels in chip_smoke.py).
FLASH_LIMIT, LSE_LIMIT = 1e-2, 1e-3


@pytest.mark.parametrize("hd,b,t,seq_len", [(32, 2, 300, 250), (64, 2, 130, 130),
                                            (32, 1, 1000, 950), (64, 8, 4501, 4501)])
def test_flash_attention_bhtd(dev, hd, b, t, seq_len):
    """Contiguous [B, 3, T, D]: o and lse, then dq, dk, dv (padded keys 0);
    controls: the keys of the last partial tile masked (forward), delta
    left out (backward)."""
    q, k, v, do = (_randn((b, 3, t, hd), 1.0, s) for s in range(4))
    reset_launch_counts()
    o, lse = flash_attention_fwd(q, k, v, seq_len)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, seq_len)
    assert _rel(o, o_p) < FLASH_LIMIT and float((lse - lse_p).abs().max()) < LSE_LIMIT
    o_c = flash_attention_fwd_plain(q, k, v, (seq_len - 1) // 64 * 64)[0]
    assert _rel(o, o_c) >= FLASH_LIMIT
    got = flash_attention_bwd(q, k, v, o, lse, do, seq_len)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, seq_len)
    assert max(_rels(got, want)) < FLASH_BWD_LIMIT, _rels(got, want)
    assert not got[1][:, :, seq_len:].any() and not got[2][:, :, seq_len:].any()
    ctrl = flash_attention_bwd_plain(q, k, v, torch.zeros_like(o), lse, do, seq_len)
    assert max(_rels(got, ctrl)) >= FLASH_BWD_LIMIT
    assert launches["flash_attention"] == 1 and launches["flash_attention_bwd"] == 1
    assert launches["flash_packed"] == launches["flash_packed_bwd"] == 0


@pytest.mark.parametrize("b,t,seq_len", [(1, 300, 250), (8, 4501, 4501)])
def test_flash_attention_on_qkv_views(dev, b, t, seq_len):
    """ViT-Ti's 3 heads of 64 from the qkv projection output, by strides:
    the packed entries dispatch to the BHTD kernels, o lands in the packed
    layout and the gradient in one [B, T, 3*192] tensor."""
    d = 192
    qkv = _randn((b, t, 3 * d), 1.0, 0)
    do = _randn((b, t, d), 1.0, 1)
    reset_launch_counts()
    parts = [slice(j * d, (j + 1) * d) for j in range(3)]
    o, lse = flash_attention_packed_layout(*(qkv[..., p] for p in parts), 3, seq_len)
    o_p, lse_p = flash_attention_packed_layout(*(qkv[..., p] for p in parts), 3, seq_len,
                                               plain=True)
    assert _rel(o, o_p) < FLASH_LIMIT and float((lse - lse_p).abs().max()) < LSE_LIMIT
    leaf = qkv.clone().requires_grad_(True)
    g_k, = torch.autograd.grad(flash_attention_fn(leaf, 3, seq_len), leaf, do)
    g_p, = torch.autograd.grad(flash_attention_fn(leaf, 3, seq_len, plain=True), leaf, do)
    rels = [_rel(g_k[..., p], g_p[..., p]) for p in parts]
    assert max(rels) < FLASH_BWD_LIMIT, rels
    assert not g_k[:, seq_len:, d:].any()
    # control: delta = rowsum(dO * O) left out (O = 0)
    views = [heads_view(qkv[..., p], 3) for p in parts]
    ctrl = flash_attention_bwd_plain(*views, torch.zeros_like(views[0]), lse_p,
                                     heads_view(do, 3), seq_len)
    assert max(_rel(g_k[..., p], c.transpose(1, 2).reshape(b, t, d))
               for p, c in zip(parts, ctrl)) >= FLASH_BWD_LIMIT
    assert launches["flash_attention"] == 2 and launches["flash_attention_bwd"] == 1
    assert launches["flash_packed"] == launches["flash_packed_bwd"] == 0


def test_training_launch_counts(dev):
    x = _randn((64, D), 1.0, 0)
    g, b = torch.ones(D, device="cuda"), torch.zeros(D, device="cuda")
    reset_launch_counts()
    y, xhat, inv = layernorm_train(x, g, b)
    layernorm_bwd(x, xhat, inv, g)
    layernorm_bwd_plain(x, xhat, inv, g)
    assert launches["layernorm_train"] == 1 and launches["layernorm_bwd"] == 1
    assert launches["layernorm"] == 0


# The other serving configurations' kernels (limits those of chip_smoke.py).
INT8_LIMIT = 5e-4
MLP_LIMIT = 1e-3
LN_DENSE_LIMIT = 1e-3
PATCH_LIMIT = 1e-3


def fused_mlp_int8_block_scale(x, w1q, s1, b1, w2q, s2, b2, res, gelu_mode, rows=32):
    """Control fault: one scale of h per block of ``rows`` rows, not per row."""
    from intentbev_torch.ops.fused_ln_mlp import gelu
    from intentbev_torch.ops.int8 import int_matmul

    d = x.shape[-1]
    xq, xs = quantize_rows(x.reshape(-1, d))
    h = gelu(int_matmul(xq, w1q.t()) * xs * s1 + b1, gelu_mode)
    n = h.shape[0]
    amax = h.abs().amax(-1)
    pad = torch.nn.functional.pad(amax, (0, -n % rows)).reshape(-1, rows).amax(-1)
    hs = (pad.repeat_interleave(rows)[:n, None].clamp(min=1e-8) / 127.0)
    hq = torch.clamp(torch.round(h / hs), -127, 127)
    y = int_matmul(hq, w2q.t()) * hs * s2 + b2
    return (y + res.reshape(-1, d).float()).to(x.dtype).reshape(x.shape)


def int8_inputs(rows, seed=0):
    """Rows of varied scale (as a residual stream's are), the f32 weights'
    codes and scales, f32 biases."""
    scale = torch.exp(0.5 * torch.randn(rows, 1, generator=_gen(seed), device="cuda"))
    x = (torch.randn(rows, D, generator=_gen(seed + 1), device="cuda") * scale).bfloat16()
    res = _randn((rows, D), 1.0, seed + 2)
    w1q, s1 = quantize_linear(_randn((4 * D, D), D ** -0.5, seed + 3, torch.float32))
    w2q, s2 = quantize_linear(_randn((D, 4 * D), (4 * D) ** -0.5, seed + 4, torch.float32))
    b1 = _randn((4 * D,), 0.1, seed + 5, torch.float32)
    b2 = _randn((D,), 0.1, seed + 6, torch.float32)
    return x, w1q, s1, b1, w2q, s2, b2, res


@pytest.mark.parametrize("gelu", ["erf", "sigmoid"])
@pytest.mark.parametrize("rows", [100, MAIN_ROWS])
def test_fused_mlp_int8(dev, rows, gelu):
    args = int8_inputs(rows)
    reset_launch_counts()
    got = fused_mlp_int8(*args, gelu)
    assert launches["fused_mlp_int8"] == 1
    assert _rel(got, fused_mlp_int8_plain(*args, gelu)) < INT8_LIMIT
    assert _rel(got, fused_mlp_int8_block_scale(*args, gelu)) >= INT8_LIMIT


@pytest.mark.parametrize("gelu", ["erf", "sigmoid"])
@pytest.mark.parametrize("rows", [100, MAIN_ROWS])
def test_fused_mlp(dev, rows, gelu):
    h, res = _randn((rows, D), 1.0, 0), _randn((rows, D), 1.0, 1)
    _, _, w1, b1, w2, b2 = _mlp_params()
    got = fused_mlp(h, w1, b1, w2, b2, res, gelu_mode=gelu)
    assert _rel(got, fused_mlp_plain(h, w1, b1, w2, b2, res, gelu_mode=gelu)) < MLP_LIMIT
    ctrl = fused_mlp_plain(h, w1, torch.zeros_like(b1), w2, b2, res, gelu_mode=gelu)
    assert _rel(got, ctrl) >= MLP_LIMIT  # control: b1 left out


@pytest.mark.parametrize("rows,dout,gelu", [(100, 3 * D, None), (MAIN_ROWS, 3 * D, None),
                                            (100, D // 2, "erf"), (8 * 4500, D // 2, "sigmoid")])
def test_fused_ln_dense(dev, rows, dout, gelu):
    x = _randn((rows, D), 1.5, 0) + 0.3
    g = _randn((D,), 0.2, 1, torch.float32) + 1
    b = _randn((D,), 0.2, 2, torch.float32)
    w = _randn((dout, D), D ** -0.5, 3)
    bias = _randn((dout,), 0.1, 4, torch.float32)
    got = fused_ln_dense(x, g, b, w, bias, gelu_mode=gelu)
    assert got.shape == (rows, dout)
    assert _rel(got, fused_ln_dense_plain(x, g, b, w, bias, gelu_mode=gelu)) < LN_DENSE_LIMIT
    # control: the GELU epilogue skipped, or (no GELU) the bias left out
    ctrl = (fused_ln_dense_plain(x, g, b, w, bias) if gelu else
            fused_ln_dense_plain(x, g, b, w, torch.zeros_like(bias)))
    assert _rel(got, ctrl) >= LN_DENSE_LIMIT


@pytest.mark.parametrize("shape", [(2, 16, 96, 290), (8, 400, 720, 290)])
def test_patch_embed(dev, shape):
    x = _randn(shape, 1.0, 0)
    w = _randn((8, 8, shape[-1], D), 0.02, 1)
    bias = _randn((D,), 0.1, 2, torch.float32)
    got = patch_embed(x, w, bias, 8)
    assert got.shape == (shape[0], (shape[1] // 8) * (shape[2] // 8), D)
    assert _rel(got, patch_embed_plain(x, w, bias, 8)) < PATCH_LIMIT
    ctrl = patch_embed_plain(x, w.transpose(0, 1).contiguous(), bias, 8)  # w read as [dx, dy]
    assert _rel(got, ctrl) >= PATCH_LIMIT


# The training entries of the MLP without LN and of the LN + dense (limits
# those of chip_smoke.py). ``intentbev_torch.ops`` re-exports functions named
# like their modules, hence importlib for the control's fault.
LN_DENSE_BWD_LIMIT = 2e-3


def _gelu_grad_skipped(monkeypatch, module):
    """Control fault: the plain backward of ``module`` takes GELU'(g) as 1."""
    monkeypatch.setattr(importlib.import_module(f"intentbev_torch.ops.{module}"),
                        "gelu_erf_grad", torch.ones_like)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("b,t", [(2, 50), (8, 4501)])
def test_fused_mlp_train_and_bwd(dev, b, t, gated, monkeypatch):
    h, res = _randn((b, t, D), 1.0, 0), _randn((b, t, D), 1.0, 11)
    _, _, w1, b1, w2, b2 = _mlp_params()
    gate = None
    if gated:
        gate = _gate(b, t, 9)
        gate[0] = 0.0  # one sample dropped
    reset_launch_counts()
    y = fused_mlp_train(h, w1, b1, w2, b2, res, gate)
    assert _rel(y, fused_mlp_plain(h, w1, b1, w2, b2, res, gate=gate)) < MLP_LIMIT
    # control: the gate ignored, or (no gate) b1 left out
    ctrl = fused_mlp_plain(h, w1, b1 if gated else torch.zeros_like(b1), w2, b2, res)
    assert _rel(y, ctrl) >= MLP_LIMIT
    dy = _randn((b, t, D), 1.0, 10)
    got = fused_mlp_bwd(h, w1, b1, w2, gate, dy)
    assert launches["fused_mlp_train"] == 1 and launches["fused_mlp_bwd"] == 1
    want = fused_mlp_bwd_plain(h, w1, b1, w2, gate, dy)
    assert max(_rels(got, want)) < MLP_BWD_LIMIT, _rels(got, want)
    # control: the gate ignored, or (no gate) GELU' skipped
    if gated:
        ctrl = fused_mlp_bwd_plain(h, w1, b1, w2, None, dy)
    else:
        _gelu_grad_skipped(monkeypatch, "fused_mlp")
        ctrl = fused_mlp_bwd_plain(h, w1, b1, w2, gate, dy)
    assert max(_rels(got, ctrl)) >= MLP_BWD_LIMIT


def ln_dense_bwd_no_m2(x, g, b, w, bias, dy):
    """Control fault (no GELU): dx through an LN backward without its
    mean(dyg * xhat) term; the other gradients sound."""
    _, dgamma, dbeta, dw, db = fused_ln_dense_bwd_plain(x, g, b, w, bias, dy)
    _, xhat, inv = layernorm_train_plain(x, g, b)
    dxn = torch.matmul(dy.float(), w.float())
    return (layernorm_bwd_no_m2(dxn, xhat, inv, g)[0].to(x.dtype), dgamma, dbeta, dw, db)


@pytest.mark.parametrize("rows,dout,gelu", [(100, 3 * D, None), (MAIN_ROWS, 3 * D, None),
                                            (100, D // 2, "erf"), (8 * 4500, D // 2, "erf")])
def test_fused_ln_dense_bwd(dev, rows, dout, gelu, monkeypatch):
    x = _randn((rows, D), 1.5, 0) + 0.3
    g = _randn((D,), 0.2, 1, torch.float32) + 1
    b = _randn((D,), 0.2, 2, torch.float32)
    w = _randn((dout, D), D ** -0.5, 3)
    bias = _randn((dout,), 0.1, 4, torch.float32)
    dy = _randn((rows, dout), 1.0, 5)
    reset_launch_counts()
    got = fused_ln_dense_bwd(x, g, b, w, bias, dy, gelu_mode=gelu)
    assert launches["fused_ln_dense_bwd"] == 1
    assert [tuple(t.shape) for t in got] == [(rows, D), (D,), (D,), (dout, D), (dout,)]
    want = fused_ln_dense_bwd_plain(x, g, b, w, bias, dy, gelu_mode=gelu)
    assert max(_rels(got, want)) < LN_DENSE_BWD_LIMIT, _rels(got, want)
    # control: GELU' skipped, or (no GELU) the LN backward without its m2 term
    if gelu:
        _gelu_grad_skipped(monkeypatch, "fused_ln_dense")
        ctrl = fused_ln_dense_bwd_plain(x, g, b, w, bias, dy, gelu_mode=gelu)
    else:
        ctrl = ln_dense_bwd_no_m2(x, g, b, w, bias, dy)
    assert max(_rels(got, ctrl)) >= LN_DENSE_BWD_LIMIT


# Row 11 (the split and chunked backwards) and the packed path at head dim
# 32 (limits those of chip_smoke.py phase 11: sound readings <= 1.9e-4, a
# moved rounding point >= 2.5e-3 on dk).
ROW11_LIMIT = 7e-4
tfp = importlib.import_module("intentbev_torch.ops.flash_packed")
# (b, t, seq_len, chunk): the chunk divides JAX's padded length (768 rows
# at T=300, 4608 at 4501), so the chunked form runs
FORM_SHAPES = [(1, 300, 250, 256), (8, 4501, 4501, 1152)]


def _packed_bwd_parts(fn, q, k, v, o, lse, do, heads, seq_len, form, chunk):
    fused, kv_chunk = {"fused": (True, 0), "split": (False, 0), "chunked": (False, chunk)}[form]
    g = fn(q, k, v, o, lse, do, heads, seq_len, fused, kv_chunk)
    return [g[..., j * D:(j + 1) * D] for j in range(3)]


@pytest.mark.parametrize("b,t,seq_len,chunk", FORM_SHAPES)
def test_flash_packed_head_dim_32(dev, monkeypatch, b, t, seq_len, chunk):
    """12 heads of 32 on qkv slices: the forward (control: q scaled by the
    f32 scale, seen in lse) and the backward in each form (controls: another
    form's rounding), each form counted under its own name."""
    qkv = _randn((b, t, 3 * D), 1.0, 0)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    do = _randn((b, t, D), 1.0, 1)
    o, lse = flash_attention_packed(q, k, v, 12, seq_len)
    o_p, lse_p = flash_attention_packed_plain(q, k, v, 12, seq_len)
    assert _rel(o, o_p) < FLASH_LIMIT and float((lse - lse_p).abs().max()) < LSE_LIMIT
    for form, ctrl_form in (("fused", "split"), ("split", "fused"), ("chunked", "split")):
        reset_launch_counts()
        got = _packed_bwd_parts(flash_attention_packed_bwd, q, k, v, o, lse, do, 12, seq_len,
                                form, chunk)
        assert launches[tfp.BWD_COUNTERS[form]] == 1 and sum(launches.values()) == 1
        want = _packed_bwd_parts(flash_attention_packed_bwd_plain, q, k, v, o, lse, do, 12,
                                 seq_len, form, chunk)
        assert max(_rels(got, want)) < ROW11_LIMIT, (form, _rels(got, want))
        assert not got[1][:, seq_len:].any() and not got[2][:, seq_len:].any()
        ctrl = _packed_bwd_parts(flash_attention_packed_bwd_plain, q, k, v, o, lse, do, 12,
                                 seq_len, ctrl_form, chunk)
        assert max(_rels(got, ctrl)) >= ROW11_LIMIT, (form, _rels(got, ctrl))
    monkeypatch.setattr(tfp, "scales", lambda dh, dtype: (dh ** -0.5, dh ** -0.5))
    lse_c = flash_attention_packed_plain(q, k, v, 12, seq_len)[1]
    assert float((lse - lse_c).abs().max()) >= LSE_LIMIT


@pytest.mark.parametrize("b,t,seq_len,chunk", FORM_SHAPES)
def test_flash_bwd_forms_head_dim_64(dev, b, t, seq_len, chunk):
    """6 heads of 64: the split and chunked kernels against their plain
    versions (control: delta left out); at head dim 64 every form gives the
    fused kernel's values."""
    qkv = _randn((b, t, 3 * D), 1.0, 0)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    do = _randn((b, t, D), 1.0, 1)
    o, lse = flash_attention_packed(q, k, v, 6, seq_len)
    fused = _packed_bwd_parts(flash_attention_packed_bwd, q, k, v, o, lse, do, 6, seq_len,
                              "fused", chunk)
    for form in ("split", "chunked"):
        reset_launch_counts()
        got = _packed_bwd_parts(flash_attention_packed_bwd, q, k, v, o, lse, do, 6, seq_len,
                                form, chunk)
        assert launches[tfp.BWD_COUNTERS[form]] == 1 and sum(launches.values()) == 1
        want = _packed_bwd_parts(flash_attention_packed_bwd_plain, q, k, v, o, lse, do, 6,
                                 seq_len, form, chunk)
        assert max(_rels(got, want)) < ROW11_LIMIT, (form, _rels(got, want))
        ctrl = _packed_bwd_parts(flash_attention_packed_bwd_plain, q, k, v, torch.zeros_like(o),
                                 lse, do, 6, seq_len, form, chunk)
        assert max(_rels(got, ctrl)) >= ROW11_LIMIT
        assert all(torch.equal(a, f) for a, f in zip(got, fused)), form


def test_packed_head_dim_128_raises(dev):
    """Heads of 128 pair into 128 lanes, but the packed kernels are built for
    head dims 32 and 64: the entries raise, naming the head dim."""
    x = _randn((1, 64, 256), 1.0, 0)
    with pytest.raises(ValueError, match="head dim 128"):
        flash_attention_packed(x, x, x, 2)
    with pytest.raises(ValueError, match="head dim 128"):
        flash_attention_packed_bwd(x, x, x, x, torch.zeros(1, 2, 64, device="cuda"), x, 2)


# Rows 18 and 19 (limits those of chip_smoke.py phase 13). The int8 kernel
# computes the plain version's integer products exactly; they differ only
# where denom's f32 sum order tips o to the neighbouring bf16. Control: P's
# codes rounded against a running max over 64-key tiles (an online softmax).
# On an H100: <= 3.5e-5 against the control's >= 3.1e-2.
FLASH_INT8_LIMIT = 2e-3
# The projection: f32 sums in another order under one bf16 rounding.
# Controls: the forward with the Dense output rounded to bf16 before the
# gate and the residual (the model's unfused rounding); the backward with
# db summed from the rounded dyg_c (with a gate; without one dyg_c = dy, and
# the control is dW rounded to bf16). On an H100: forward <= 5.7e-5 against
# the control's 2.2e-3; backward dx <= 4.4e-5, dW <= 1.3e-6, db <= 5.1e-7,
# the control's db 1.7e-3.
PROJ_LIMIT = 3e-4
PROJ_BWD_LIMITS = (1e-3, 1e-4, 1e-4)  # dx, dW, db


@pytest.mark.parametrize("heads", [6, 12])
@pytest.mark.parametrize("b,t,seq_len", [(1, 300, 250), (8, 4608, 4501)])
def test_flash_int8(dev, b, t, seq_len, heads):
    """Int8 attention on qkv slices at 6 heads of 64 and 12 of 32 against
    its plain version; one launch counted."""
    qkv = _randn((b, t, 3 * D), 1.0, 0)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    reset_launch_counts()
    got = flash_attention_packed_int8(q, k, v, heads, seq_len)
    assert launches["flash_int8"] == 1 and sum(launches.values()) == 1
    want = flash_attention_packed_int8_plain(q, k, v, heads, seq_len)
    assert _rel(got, want) < FLASH_INT8_LIMIT
    ctrl = flash_attention_packed_int8_plain(q, k, v, heads, seq_len, p_max="tile")
    assert _rel(got, ctrl) >= FLASH_INT8_LIMIT


def test_flash_int8_v_scale_takes_masked_rows(dev):
    """v's rows past seq_len enter its panel scale: scaled x50 there, they
    change o (with its scale over the real rows only, o would not move)."""
    qkv = _randn((2, 300, 3 * D), 1.0, 0)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    o = flash_attention_packed_int8(q, k, v, 6, 250)
    v[:, 250:] *= 50
    o50 = flash_attention_packed_int8(q, k, v, 6, 250)
    assert _rel(o50, flash_attention_packed_int8_plain(q, k, v, 6, 250)) < FLASH_INT8_LIMIT
    assert _rel(o50, o) >= FLASH_INT8_LIMIT


def test_flash_int8_raises(dev):
    """Head dims other than 32 and 64, and f32 inputs, raise on the card."""
    x = _randn((1, 64, 256), 1.0, 0)
    with pytest.raises(ValueError, match="head dim 128"):
        flash_attention_packed_int8(x, x, x, 2)
    x32 = x[..., :128].float()
    with pytest.raises(ValueError, match="bf16"):
        flash_attention_packed_int8(x32, x32, x32, 2)


def _proj_args(n, d_in, d_out, gated):
    x, r = _randn((n, d_in), 1.0, 0), _randn((n, d_out), 1.0, 1)
    w, bias = _randn((d_in, d_out), d_in ** -0.5, 2), _randn((d_out,), 0.1, 3, torch.float32)
    # a per-sample drop-path gate (keep 0.9) over samples of 4608 rows
    keep = (torch.rand(-(-n // 4608), generator=_gen(4), device="cuda") < 0.9).float() / 0.9
    gate = keep.repeat_interleave(4608)[:n, None].contiguous() if gated else torch.ones(
        n, 1, device="cuda")
    return x, w, bias, r, gate


def _proj_unfused(x, w, bias, r, gate):  # control: the Dense output rounded first
    return ((torch.matmul(x.float(), w.float()) + bias).to(x.dtype).float() * gate
            + r.float()).to(x.dtype)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("n,d_in,d_out", [(600, 384, 192), (600, 192, 384),
                                          (8 * 4608, 384, 384)])
def test_fused_proj(dev, n, d_in, d_out, gated):
    """The forward and the backward kernels against their plain versions;
    one launch each."""
    x, w, bias, r, gate = _proj_args(n, d_in, d_out, gated)
    reset_launch_counts()
    y = fused_proj_fwd(x, w, bias, r, gate)
    assert launches["fused_proj"] == 1 and sum(launches.values()) == 1
    assert _rel(y, fused_proj_fwd_plain(x, w, bias, r, gate)) < PROJ_LIMIT
    assert _rel(y, _proj_unfused(x, w, bias, r, gate)) >= PROJ_LIMIT
    dy = _randn((n, d_out), 1.0, 5)
    got = fused_proj_bwd(x, w, dy, gate)
    assert launches["fused_proj_bwd"] == 1
    want = fused_proj_bwd_plain(x, w, dy, gate)
    assert all(r_ < lim for r_, lim in zip(_rels(got, want), PROJ_BWD_LIMITS)), _rels(got, want)
    if gated:  # control: db from the rounded dyg_c
        ctrl = (want[0], want[1], (dy.float() * gate).bfloat16().float().sum(0))
    else:  # dyg_c = dy, so no rounding point moves; control: dW rounded to bf16
        ctrl = (want[0], want[1].bfloat16(), want[2])
    assert any(r_ >= lim for r_, lim in zip(_rels(got, ctrl), PROJ_BWD_LIMITS))


def test_fused_dense_residual_autograd(dev):
    """The autograd function through the kernels against itself through the
    plain versions: d residual = dy, d gate = 0, dW in w's dtype."""
    x, w, bias, r, _ = _proj_args(2 * 300, 384, 384, False)
    gate = (torch.rand(2, 1, generator=_gen(6), device="cuda") < 0.9).float() / 0.9
    dy = _randn((2, 300, 384), 1.0, 7)
    grads = []
    for plain in (False, True):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x.view(2, 300, 384), w, bias, r.view(2, 300, 384), gate)]
        reset_launch_counts()
        y = fused_dense_residual(*leaves[:4], leaves[4], plain=plain)
        y.backward(dy)
        assert launches["fused_proj"] == launches["fused_proj_bwd"] == (0 if plain else 1)
        grads.append([y] + [t.grad for t in leaves])
    (y, dx, dw, db, dr, dg), want = grads[0], grads[1]
    assert _rel(y, want[0]) < PROJ_LIMIT
    assert all(r_ < lim for r_, lim in zip(_rels((dx, dw, db), want[1:4]), PROJ_BWD_LIMITS))
    assert dw.dtype == torch.bfloat16 and torch.equal(dr, dy) and not dg.any()


def test_fused_proj_raises(dev):
    """Widths other than 192 and 384, and f32 activations, raise on the card."""
    x, w, bias, r, gate = _proj_args(64, 384, 384, False)
    with pytest.raises(ValueError, match="d_in and d_out"):
        fused_proj_fwd(x[:, :128].contiguous(), w[:128].contiguous(), bias, r, gate)
    with pytest.raises(ValueError, match="bf16"):
        fused_proj_fwd(x.float(), w, bias, r, gate)
    with pytest.raises(ValueError, match="bf16"):
        fused_proj_bwd(x, w, r.float(), gate)
