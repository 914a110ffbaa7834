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
and at 12 heads of 32, with the packed forward at head dim 32; the Hopper
backward kernels (TMA rings, wgmma) also on ragged tiles and a 128-key
block wholly past seq_len, twice each (the same bits), and refuse a view
TMA cannot take. The Hopper forward runs JAX's three softmax forms (the
monolithic safe, the fixed max and the chunked safe) on the same shapes,
each against its plain version in that form and, as a control, another
form's: the relative L2 and the share of o's elements that differ. The library
ops of ``ops.experimental`` (rows 18 and 19: the int8 attention at head
dims 16 to 128 in bf16 and f32, twice each for the same bits; the residual
projection forward and backward) run at small and at the attention
sublayer's shapes, and raise on what they are not built for.
The Hopper LN+MLP forward (its three entries) runs at row counts that are
not a multiple of its 128-row block, with and without the gate, both
GELUs, D=384 and 192, LN or none; its outputs are also read by the share
of elements that differ, which an h kept in f32 before fc2 must move. The
Hopper LN+MLP backward (the row kernel and the dW products) runs at 1 to
36008 rows, gated, ungated and with dropped rows, D=384 and 192 with LN and
384 without; dx is also read by the share of elements that differ, which a
dg kept in f32 before the dxn product must move, and two calls must give the
same bits. The Hopper LN + dense pair (row 14, forward and backward) runs
at 1 to 36008 rows, D=384 and 192, qkv (Dout 3D, no GELU) and the adapter
(Dout 192, each GELU its entry takes), and at Dout 64, 128 and 320 (the
forward's last 192-wide column tile partial): y's and dx's shares of
differing elements (controls: xn kept in f32 before the product; dg kept
in f32 before dxn, or without GELU dxn rounded before the LN backward), and
two calls give the same bits. Row 17, the W8A8 MLP (Hopper, s8 wgmma), runs
at 1 to 36008 rows (blocks of 64), D=384 and 192, hidden 4D and 4D - 128, both
GELUs: y's relative L2 and share of differing elements against the plain
version, which it matches bit for bit (controls: one h scale per 32-row
block; h rounded to bf16 before its codes), two calls with the same bits,
and the shapes it refuses. The patch embeds run at D=384 and 192: row 15
(Hopper, wgmma fed by TMA) on one token, 12 tokens a patch row, gw = 90 over
an odd count of patch rows and the full bench batch, C = 128 and 290, read
by relative L2 and share (controls: the weight read as w[dx, dy]; the sum
rounded to bf16 before the bias), and the shapes it refuses; row 1 (the
token-ordered hit list, then a warp a token) at the bench density, with an
empty batch element, ~5000 hits in one token, a band filled to its
capacity and an out-of-range channel, its hit list equal to the plain
version's entry for entry; both give the same bits on two calls. The LN
backward (row 9: a persistent grid, then one column-sum launch) runs at 1
to 36864 rows, D=384 and 192; the residual projection (row 19, forward
and backward on wgmma fed by TMA) at 1 to 36864 rows, every (d_in, d_out)
pair of 192 and 384, gated and not: dx's and y's shares of differing
elements with their controls, and two calls with the same bits. A TMA
entry whose first CUDA call on a host thread is its own (autograd's worker
with a warm allocator) must still encode its tensor maps.
"""

import importlib
import threading

import numpy as np
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
    voxel_embed_tokens_plain, voxel_fill_bev, voxel_fill_bev_plain, voxel_hits,
    voxel_hits_plain)
from intentbev_torch.ops.experimental import (  # noqa: E402
    flash_attention_packed_int8, flash_attention_packed_int8_plain, fused_dense_residual,
    fused_proj_bwd, fused_proj_bwd_plain, fused_proj_fwd, fused_proj_fwd_plain)
from intentbev_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_packed_layout, heads_view)
from intentbev_torch.ops.voxel_embed import (  # noqa: E402
    CAP, WINDOW, VoxelChunks, chunks_to_device, decode_chunk_transport)
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


MLP_SHARE = 2e-2  # share of the forward's bf16 outputs that may differ


def _mlp_h_f32(x, w1, b1, w2, b2, mode, ln=None, gate=None, res=None, ln_next=None):
    """The plain forwards' math with one fault: h kept in f32 before fc2.
    x's rows (LN2 with ``ln``, or none), the residual ``res`` (x if None), the
    per-row ``gate``, the next LN ``ln_next`` -> y (and yn)."""
    from intentbev_torch.ops.fused_ln_mlp import gelu

    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    xn = layernorm_plain(xf, *ln).to(x.dtype).float() if ln else xf
    m = gelu(xn @ w1.float().t() + b1, mode) @ w2.float().t() + b2
    if gate is not None:
        m = m * gate.float().reshape(-1, 1)
    y = m + (x if res is None else res).reshape(-1, d).float()
    y_lp = y.to(x.dtype).reshape(x.shape)
    return (y_lp, layernorm_plain(y, *ln_next).to(x.dtype)) if ln_next else (y_lp,)


def _share(got, want):
    return float((got != want).float().mean())


@pytest.mark.parametrize("entry,d,gated", [
    ("fused_ln_mlp", 384, False), ("fused_ln_mlp", 192, False),
    ("fused_ln_mlp_train", 384, True), ("fused_ln_mlp_train", 384, False),
    ("fused_ln_mlp_train", 192, True), ("fused_ln_mlp_train", 192, False),
    ("fused_mlp", 384, True), ("fused_mlp", 384, False)])
@pytest.mark.parametrize("gelu", ["erf", "sigmoid"])
@pytest.mark.parametrize("rows", [300, MAIN_ROWS])
def test_ln_mlp_forward_edges(dev, rows, gelu, entry, d, gated):
    """The Hopper forward (128-row blocks; rows past the last land as TMA's
    zeros and are not stored) at row counts that are not a multiple of the
    block, with and without the gate, both GELUs, D=384 and 192, LN or
    none: each output's relative L2 and share of differing elements against
    the plain version; the control, h kept in f32 before fc2, must move the
    share past its limit."""
    x, res = _randn((rows, d), 1.0, 0), _randn((rows, d), 1.0, 11)
    ln = [_randn((d,), 0.2, s, torch.float32) + (1 - s % 2) for s in (1, 2, 3, 4)]
    w1 = _randn((4 * d, d), d ** -0.5, 5)
    b1 = _randn((4 * d,), 0.1, 6, torch.float32)
    w2 = _randn((d, 4 * d), (4 * d) ** -0.5, 7)
    b2 = _randn((d,), 0.1, 8, torch.float32)
    keep = torch.rand(rows, generator=_gen(9), device="cuda") < 0.7
    gate = keep.float() / 0.9 if gated else None  # per row: 0 or 1/0.9
    reset_launch_counts()
    if entry == "fused_ln_mlp":
        args = (x, ln[0], ln[1], w1, b1, w2, b2, ln[2], ln[3])
        got = fused_ln_mlp(*args, gelu_mode=gelu)
        want = fused_ln_mlp_plain(*args, gelu_mode=gelu)
        ctrl = _mlp_h_f32(x, w1, b1, w2, b2, gelu, ln=ln[:2], ln_next=ln[2:])
    elif entry == "fused_ln_mlp_train":
        args = (x, ln[0], ln[1], w1, b1, w2, b2, gate)
        got = (fused_ln_mlp_train(*args, gelu_mode=gelu),)
        want = (fused_ln_mlp_train_plain(*args, gelu_mode=gelu),)
        ctrl = _mlp_h_f32(x, w1, b1, w2, b2, gelu, ln=ln[:2], gate=gate)
    else:
        got = (fused_mlp(x, w1, b1, w2, b2, res, gelu, gate),)
        want = (fused_mlp_plain(x, w1, b1, w2, b2, res, gelu, gate),)
        ctrl = _mlp_h_f32(x, w1, b1, w2, b2, gelu, gate=gate, res=res)
    assert launches[entry] == 1
    for g, w, c in zip(got, want, ctrl):
        assert g.shape == w.shape and _rel(g, w) < MLP_LIMIT, _rel(g, w)
        assert _share(g, w) < MLP_SHARE, _share(g, w)
    assert max(_share(g, c) for g, c in zip(got, ctrl)) >= MLP_SHARE


@pytest.mark.parametrize("b,t,seq_len", [(1, 300, 250), (2, 130, 130), (8, 4501, 4501)])
def test_flash_packed_on_qkv_slices(dev, b, t, seq_len):
    qkv = _randn((b, t, 3 * D), 1.0, 0)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    o, lse = flash_attention_packed(q, k, v, 6, seq_len)
    o_ref, lse_ref = flash_attention_packed_plain(q, k, v, 6, seq_len)
    assert o.shape == (b, t, D) and lse.shape == (b, 6, t)
    assert _rel(o, o_ref) < 1e-2
    assert float((lse - lse_ref).abs().max()) < 1e-3
    # control: the keys from the last multiple of 64 below seq_len on masked
    o_ctl, _ = flash_attention_packed_plain(q, k, v, 6, (seq_len - 1) // 64 * 64)
    assert _rel(o, o_ctl) >= 1e-2


def _chunks(grid, batch, points, seed, num_chunks):
    pts, valid, _ = serving_batch(grid, batch, points, seed)
    host = build_chunk_transport(pts, valid, grid, 8, num_chunks)
    return decode_chunk_transport(chunks_to_device(host, "cuda"))


VOXEL_LIMIT = 3e-3  # relative L2 of row 1's tokens against the plain version


def _check_voxel_embed(chunks, c, d, hw, control=True):
    """Row 1 against its plain version: the tokens' relative L2 and share of
    differing elements (the plain version's index_add runs in another
    order), the hit list of its first kernel equal entry for entry to the
    plain one's, two calls with the same bits; control: the last chunk of
    each band skipped."""
    w = _randn((8, 8, c, d), 0.05, 1)
    bias = _randn((d,), 0.1, 2, torch.float32)
    reset_launch_counts()
    got = voxel_embed_tokens(chunks, w, bias, 8, hw)
    again = voxel_embed_tokens(chunks, w, bias, 8, hw)
    assert launches["voxel_embed"] == 2
    want = voxel_embed_tokens_plain(chunks, w, bias, 8, hw)
    assert got.shape == ((chunks.wid.shape[0], (hw[0] // 8) * (hw[1] // 8), d))
    assert _rel(got, want) < VOXEL_LIMIT
    assert _share(got, want) < MLP_SHARE, _share(got, want)
    assert torch.equal(got, again)  # deterministic
    hk, hp = voxel_hits(chunks, c, 8, hw), voxel_hits_plain(chunks, c, 8, hw)
    assert launches["voxel_hits"] == 1 and launches["voxel_embed"] == 2
    assert torch.equal(hk.offsets, hp.offsets)
    used = torch.arange(hp.wrow.shape[-1], device="cuda") < hp.offsets[..., -1:].long()
    assert torch.equal(hk.wrow[used], hp.wrow[used]) and torch.equal(hk.val[used], hp.val[used])
    if control:
        skipped = chunks._replace(count=(chunks.count - 1).clamp(min=0))
        assert _rel(got, voxel_embed_tokens_plain(skipped, w, bias, 8, hw)) >= VOXEL_LIMIT
    return got, bias


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("size", ["small", "main"])
def test_voxel_embed(dev, size, d):
    if size == "small":
        grid = GridConfig(height_px=80, width_px=96, lidar_height_channels=4,
                          lidar_sweeps=2)
        chunks = _chunks(grid, 2, 3000, 0, 64)
    else:  # the bench density: 8 frames of 16384 points, 512 chunks a band
        grid = default_vit_config().grid
        chunks = _chunks(grid, 8, 16384, 0, 512)
    _check_voxel_embed(chunks, grid.lidar_total_channels, d, (grid.height_px, grid.width_px))


@pytest.mark.parametrize("d", WIDTHS)
def test_voxel_embed_skips_out_of_range_channel(dev, d):
    grid = GridConfig(height_px=80, width_px=96, lidar_height_channels=4, lidar_sweeps=2)
    chunks = _chunks(grid, 1, 500, 3, 64)
    c = grid.lidar_total_channels
    ch = chunks.ch.clone()
    ch[0, 0, 0, 0, 0] = c  # must be dropped, not read past W
    chunks = chunks._replace(ch=ch)
    _check_voxel_embed(chunks, c, d, (grid.height_px, grid.width_px))


def _cell_chunks(bands, nc, grid, seed):
    """Decoded chunks on the card from cells: bands[b][band] = (pixels within
    the band, channels), unique pairs, or None; each window's cells in chunks
    of 64, non-integral values."""
    rng = np.random.default_rng(seed)
    b, nb = len(bands), len(bands[0])
    wid = np.zeros((b, nb, nc), np.int32)
    sl, ch = (np.zeros((b, nb, nc, 1, CAP), np.int32) for _ in range(2))
    val = np.zeros((b, nb, nc, 1, CAP), np.float32)
    count = np.zeros((b, nb), np.int32)
    for i, sample in enumerate(bands):
        for j, cells in enumerate(sample):
            if cells is None:
                continue
            px, chan = cells
            n = 0
            for win in np.unique(px // WINDOW):
                idx = np.nonzero(px // WINDOW == win)[0]
                for s0 in range(0, idx.size, CAP):
                    part = idx[s0:s0 + CAP]
                    wid[i, j, n] = win
                    sl[i, j, n, 0, :part.size] = px[part] % WINDOW
                    ch[i, j, n, 0, :part.size] = chan[part]
                    val[i, j, n, 0, :part.size] = rng.uniform(0.5, 255.0, part.size)
                    n += 1
            count[i, j] = n
    return VoxelChunks(*(torch.from_numpy(a).cuda() for a in (wid, sl, ch, val, count)))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("case", ["empty_sample", "one_patch", "full_band"])
def test_voxel_embed_edges(dev, case, d):
    """The flagship grid (C = 290, bands of 5 patch rows): a batch whose
    second element is empty (its tokens are the bias); 5000 hits in one
    token; a band filled to its capacity, nc chunks of 64 cells."""
    grid = default_vit_config().grid
    c, hw = grid.lidar_total_channels, (grid.height_px, grid.width_px)
    nb, band_px = grid.height_px // 40, 40 * grid.width_px
    rng = np.random.default_rng(5)
    empty = [None] * nb
    if case == "empty_sample":
        chunks = _chunks(grid, 2, 16384, 0, 512)
        chunks = chunks._replace(count=chunks.count * torch.tensor([[1], [0]], device="cuda",
                                                                   dtype=torch.int32))
    elif case == "one_patch":  # patch row 2, column 40 of band 3
        r, col = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
        pixels = ((16 + r) * grid.width_px + 320 + col).ravel()
        flat = rng.choice(pixels.size * c, 5000, replace=False)
        band = empty.copy()
        band[3] = (pixels[flat // c], (flat % c).astype(np.int32))
        chunks = _cell_chunks([band], 128, grid, 6)
    else:  # band 7: 64 windows of 64 cells, the capacity nc = 64
        px = np.arange(64)[:, None] * WINDOW * 7 + rng.integers(0, WINDOW, (64, CAP))
        chan = np.stack([rng.permutation(c)[:CAP] for _ in range(64)])
        assert px.max() < band_px
        band = empty.copy()
        band[7] = (px.ravel(), chan.ravel().astype(np.int32))
        chunks = _cell_chunks([band, empty], 64, grid, 7)
        assert int(chunks.count[0, 7]) == 64
    got, bias = _check_voxel_embed(chunks, c, d, hw)
    if case == "empty_sample":
        assert torch.equal(got[1], bias.bfloat16().expand_as(got[1]))


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


# The LN backward's dx is also read by the share of its elements that differ
# from the plain version (f32 sums in another order tip a few to the
# neighbouring bf16); the control without the mean(dyg * xhat) term moves
# most of them.
LN_BWD_SHARE = 2e-2


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", [1, 10, 300, 4501, MAIN_ROWS, 8 * 4608])
def test_layernorm_train_and_bwd(dev, rows, d):
    """The training forward and the backward (row 9: one row kernel on a
    persistent grid, then one column-sum launch) against their plain
    versions, from 1 row to the padded attention rows; two backward calls
    give the same bits."""
    x = _randn((rows, d), 2.0, 0) + 0.5
    g = _randn((d,), 0.3, 1, torch.float32) + 1
    b = _randn((d,), 0.3, 2, torch.float32)
    y, xhat, inv = layernorm_train(x, g, b)
    y_p, xhat_p, inv_p = layernorm_train_plain(x, g, b)
    assert _rel(y, y_p) < 3e-4 and _rel(xhat, xhat_p) < 3e-4 and _rel(inv, inv_p) < 1e-5
    assert _rel(y, _layernorm_unbiased(x, g, b)) >= 3e-4
    dy = _randn((rows, d), 1.0, 3)
    reset_launch_counts()
    got = layernorm_bwd(dy, xhat, inv, g)
    assert launches["layernorm_bwd"] == 1 and sum(launches.values()) == 1
    want = layernorm_bwd_plain(dy, xhat, inv, g)
    assert max(_rels(got, want)) < LN_BWD_LIMIT
    assert _share(got[0], want[0]) < LN_BWD_SHARE
    ctrl = layernorm_bwd_no_m2(dy, xhat, inv, g)
    assert max(_rels(got, ctrl)) >= LN_BWD_LIMIT and _share(got[0], ctrl[0]) >= LN_BWD_SHARE
    again = layernorm_bwd(dy, xhat, inv, g)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


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


BWD_SHARE = 2e-2  # share of dx's elements that may differ from the plain backward


def _dx_dg_f32(x, gamma, beta, w1, b1, w2, gate, dy, ln=True):
    """Control fault: the plain backward's dx with dg kept in f32 before the
    dxn product (the kernel and JAX round it to bf16 there)."""
    from intentbev_torch.ops.fused_ln_mlp import gelu_erf_grad

    dt, d = x.dtype, x.shape[-1]
    xf, dyf = x.reshape(-1, d).float(), dy.reshape(-1, d).float()
    xn = xf
    if ln:
        xc = xf - xf.mean(-1, keepdim=True)
        inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-6)
        xhat = xc * inv
        xn = (xhat * gamma + beta).to(dt).float()
    g = xn @ w1.float().t() + b1
    gt = torch.ones_like(xf[:, :1]) if gate is None else gate.float().reshape(-1, 1)
    dg = ((dyf * gt).to(dt).float() @ w2.float()) * gelu_erf_grad(g)
    dxn = dg @ w1.float()
    if not ln:
        return dxn.to(dt).reshape(x.shape)
    dyg = dxn * gamma
    dx = inv * (dyg - dyg.mean(-1, keepdim=True) - xhat * (dyg * xhat).mean(-1, keepdim=True))
    return (dx + dyf).to(dt).reshape(x.shape)


def _rel_or_zero(got, want):
    """Relative L2, or max |got| where the plain output is all zeros (a
    dropped row's dW)."""
    if float(want.double().norm()) == 0.0:
        assert torch.isfinite(got).all()
        return float(got.double().abs().max())
    return _rel(got, want)


@pytest.mark.parametrize("entry,d", [("fused_ln_mlp_bwd", 384), ("fused_ln_mlp_bwd", 192),
                                     ("fused_mlp_bwd", 384)])
@pytest.mark.parametrize("gating", ["gate", "none", "dropped"])
@pytest.mark.parametrize("rows", [1, 50, 300, 4501, MAIN_ROWS])
def test_ln_mlp_backward_edges(dev, rows, gating, entry, d):
    """The Hopper backward (64-row blocks of the row kernel, 64-row chunks
    of the dW products; rows past the last land as TMA's zeros) at row counts
    that are not a multiple of either, with a per-row gate, none, and the
    first half of the rows dropped (gate 0), D=384 and 192 with LN, 384
    without: every output's relative L2 against the plain version, dx's
    share of differing elements (the control, dg kept in f32 before the dxn
    product, must move it past the limit), and two calls give the same bits.
    The share is read from 50 rows on: a dg that rounds to the other bf16
    neighbour (the two sides' f32 sums differ in order) moves its whole row
    of dx, so one row's share is one sample of a spread (0-7.3 % over three
    seeds at one row, where 36008 rows average 0.33 %)."""
    x, dy = _randn((rows, d), 1.0, 0), _randn((rows, d), 1.0, 10)
    gamma, beta, w1, b1, w2, _ = _mlp_params(d)
    keep = torch.rand(rows, generator=_gen(9), device="cuda") < 0.7
    gate = {"gate": keep.float() / 0.9, "none": None,
            "dropped": (torch.arange(rows, device="cuda") >= rows // 2).float() / 0.9}[gating]
    ln = entry == "fused_ln_mlp_bwd"
    reset_launch_counts()
    if ln:
        args = (x, gamma, beta, w1, b1, w2, gate, dy)
        got, again = fused_ln_mlp_bwd(*args), fused_ln_mlp_bwd(*args)
        want = fused_ln_mlp_bwd_plain(*args)
    else:
        args = (x, w1, b1, w2, gate, dy)
        got, again = fused_mlp_bwd(*args), fused_mlp_bwd(*args)
        want = fused_mlp_bwd_plain(*args)
    assert launches[entry] == 2
    rels = [_rel_or_zero(a, b) for a, b in zip(got, want)]
    assert all(a.shape == b.shape for a, b in zip(got, want))
    assert max(rels) < MLP_BWD_LIMIT, rels
    if rows >= 50:
        assert _share(got[0], want[0]) < BWD_SHARE, _share(got[0], want[0])
        ctrl = _dx_dg_f32(x, gamma, beta, w1, b1, w2, gate, dy, ln)
        assert _share(got[0], ctrl) >= BWD_SHARE, _share(got[0], ctrl)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # deterministic


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


INT8_SHARE = 1e-3  # share of y's elements that may differ (sound: 0 on the card)


def _fused_mlp_int8_faulty(x, w1q, s1, b1, w2q, s2, b2, res, gelu_mode, fault):
    """Control faults of row 17: ``block_scale`` (one scale of h per block of
    32 rows, not per row) or ``h_bf16`` (h rounded to bf16 before its codes)."""
    from intentbev_torch.ops.fused_ln_mlp import gelu
    from intentbev_torch.ops.int8 import int_matmul

    d = x.shape[-1]
    xq, xs = quantize_rows(x.reshape(-1, d))
    h = gelu(int_matmul(xq, w1q.t()) * xs * s1 + b1, gelu_mode)
    if fault == "h_bf16":
        hq, hs = quantize_rows(h.bfloat16().float())
    else:
        n = h.shape[0]
        amax = torch.nn.functional.pad(h.abs().amax(-1), (0, -n % 32)).reshape(-1, 32).amax(-1)
        hs = (amax.repeat_interleave(32)[:n, None].clamp(min=1e-8) / 127.0)
        hq = torch.clamp(torch.round(h / hs), -127, 127)
    y = int_matmul(hq, w2q.t()) * hs * s2 + b2
    return (y + res.reshape(-1, d).float()).to(x.dtype).reshape(x.shape)


def int8_inputs(rows, seed=0, d=D, hidden=None):
    """Rows of varied scale (as a residual stream's are), the f32 weights'
    codes and scales (hidden 4d unless given), f32 biases."""
    hidden = hidden or 4 * d
    scale = torch.exp(0.5 * torch.randn(rows, 1, generator=_gen(seed), device="cuda"))
    x = (torch.randn(rows, d, generator=_gen(seed + 1), device="cuda") * scale).bfloat16()
    res = _randn((rows, d), 1.0, seed + 2)
    w1q, s1 = quantize_linear(_randn((hidden, d), d ** -0.5, seed + 3, torch.float32))
    w2q, s2 = quantize_linear(_randn((d, hidden), hidden ** -0.5, seed + 4, torch.float32))
    b1 = _randn((hidden,), 0.1, seed + 5, torch.float32)
    b2 = _randn((d,), 0.1, seed + 6, torch.float32)
    return x, w1q, s1, b1, w2q, s2, b2, res


# Row 17 (csrc/fused_mlp_int8.cu): 128-row blocks, the hidden dimension in
# steps of 64 (D=384) or 128 (D=192). Readings: relative L2 and the share of
# y's elements that differ from the plain version (which the kernel matches
# bit for bit); controls: one h scale per 32-row block, h rounded to bf16
# before its codes; and two calls give the same bits.
@pytest.mark.parametrize("gelu", ["erf", "sigmoid"])
@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", [1, 100, 300, 36000, MAIN_ROWS])
def test_fused_mlp_int8(dev, rows, d, narrow, gelu):
    # hidden 4d, or 4d - 128: a tile count that the kernel's ring slots (3 at
    # D=384, 4 at 192) do not divide
    args = int8_inputs(rows, d=d, hidden=4 * d - 128 * narrow)
    reset_launch_counts()
    got = fused_mlp_int8(*args, gelu)
    again = fused_mlp_int8(*args, gelu)
    assert launches["fused_mlp_int8"] == 2
    assert torch.equal(got, again)
    want = fused_mlp_int8_plain(*args, gelu)
    assert _rel(got, want) < INT8_LIMIT and _share(got, want) < INT8_SHARE
    if rows > 1:  # one row is its own 32-row block
        ctrl = _fused_mlp_int8_faulty(*args, gelu, "block_scale")
        assert _rel(got, ctrl) >= INT8_LIMIT and _share(got, ctrl) >= INT8_SHARE
    assert _share(got, _fused_mlp_int8_faulty(*args, gelu, "h_bf16")) >= INT8_SHARE


def test_fused_mlp_int8_refuses(dev):
    """Widths other than 384 and 192, and a hidden width off the kernel's step."""
    for d, hidden in ((256, 1024), (384, 96), (192, 64)):
        with pytest.raises(ValueError):
            fused_mlp_int8(*int8_inputs(64, d=d, hidden=hidden), "sigmoid")


@pytest.mark.parametrize("gelu", ["erf", "sigmoid"])
@pytest.mark.parametrize("rows", [100, MAIN_ROWS])
def test_fused_mlp(dev, rows, gelu):
    h, res = _randn((rows, D), 1.0, 0), _randn((rows, D), 1.0, 1)
    _, _, w1, b1, w2, b2 = _mlp_params()
    got = fused_mlp(h, w1, b1, w2, b2, res, gelu_mode=gelu)
    assert _rel(got, fused_mlp_plain(h, w1, b1, w2, b2, res, gelu_mode=gelu)) < MLP_LIMIT
    ctrl = fused_mlp_plain(h, w1, torch.zeros_like(b1), w2, b2, res, gelu_mode=gelu)
    assert _rel(got, ctrl) >= MLP_LIMIT  # control: b1 left out


# Row 14 (the LN + dense pair, csrc/fused_ln_dense.cu): 128-row blocks, so
# row counts below, at and past a block and one not a multiple of it (the
# adapter's 36000, qkv's 36008); D = 384 and 192; Dout = 3D (qkv, no GELU)
# and 192 (the adapter: the erf GELU of training, the serving sigmoid one).
LN_DENSE_ROWS = [1, 100, 300, 8 * 4500, MAIN_ROWS]
LN_DENSE_CASES = [(3, None), (1, "erf"), (1, "sigmoid")]  # (Dout: 3D, or 192; GELU)


def _ln_dense_inputs(rows, d, dout):
    x = _randn((rows, d), 1.5, 0) + 0.3
    g = _randn((d,), 0.2, 1, torch.float32) + 1
    b = _randn((d,), 0.2, 2, torch.float32)
    w = _randn((dout, d), d ** -0.5, 3)
    bias = _randn((dout,), 0.1, 4, torch.float32)
    return x, g, b, w, bias


def _xn_f32(x, g, b, w, bias, gelu):
    """Control fault: y with xn kept in f32 before the product (the kernel and
    JAX round it to bf16 there)."""
    from intentbev_torch.ops.fused_ln_mlp import gelu as gelu_fn

    y = layernorm_plain(x.float(), g, b) @ w.float().t() + bias
    return (gelu_fn(y, gelu) if gelu else y).to(x.dtype)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dout_x,gelu", LN_DENSE_CASES)
@pytest.mark.parametrize("rows", LN_DENSE_ROWS)
def test_fused_ln_dense(dev, rows, dout_x, gelu, d):
    """The Hopper forward against its plain version: relative L2 (control:
    the GELU epilogue skipped, or without GELU the bias left out), the share
    of y's elements that differ (control: xn kept in f32 before the product),
    read from 100 rows on (a row's share is one sample of a spread), and two
    calls give the same bits."""
    _check_ln_dense(rows, 3 * d if dout_x == 3 else 192, gelu, d)


# Dout a multiple of 64 but not of the forward's 192-wide column tile (an
# adapter width a checkpoint may give): the forward's last tile is partial
LN_DENSE_NARROW = [64, 128, 320]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("gelu", [None, "erf", "sigmoid"])
@pytest.mark.parametrize("dout", LN_DENSE_NARROW)
@pytest.mark.parametrize("rows", [300, MAIN_ROWS])
def test_fused_ln_dense_narrow(dev, rows, dout, gelu, d):
    """The forward at a Dout whose last column tile is partial: the checks
    of :func:`test_fused_ln_dense`."""
    _check_ln_dense(rows, dout, gelu, d)


def _check_ln_dense(rows, dout, gelu, d):
    x, g, b, w, bias = _ln_dense_inputs(rows, d, dout)
    reset_launch_counts()
    got = fused_ln_dense(x, g, b, w, bias, gelu_mode=gelu)
    again = fused_ln_dense(x, g, b, w, bias, gelu_mode=gelu)
    assert launches["fused_ln_dense"] == 2
    assert got.shape == (rows, dout)
    want = fused_ln_dense_plain(x, g, b, w, bias, gelu_mode=gelu)
    assert _rel(got, want) < LN_DENSE_LIMIT
    ctrl = (fused_ln_dense_plain(x, g, b, w, bias) if gelu else
            fused_ln_dense_plain(x, g, b, w, torch.zeros_like(bias)))
    assert _rel(got, ctrl) >= LN_DENSE_LIMIT
    if rows >= 100:
        assert _share(got, want) < MLP_SHARE, _share(got, want)
        ctrl = _xn_f32(x, g, b, w, bias, gelu)
        assert _share(got, ctrl) >= MLP_SHARE, _share(got, ctrl)
    assert torch.equal(got, again)  # deterministic


PATCH_SHARE = 5e-2  # share of row 15's tokens that may differ from the plain version


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("shape", [(1, 8, 8, 128), (2, 16, 96, 290), (3, 24, 720, 290),
                                   (8, 400, 720, 290)])
def test_patch_embed(dev, shape, d):
    """Row 15 on ragged shapes (one token; 12 tokens a patch row; gw = 90 over
    9 patch rows, an odd count; the full bench batch), C = 128 where P*C is a
    multiple of 64: the tokens' relative L2 and share of differing elements
    against the plain version, two calls with the same bits; controls: the
    weight read as w[dx, dy] (relative L2) and the sum rounded to bf16
    before the bias (share)."""
    x = _randn(shape, 1.0, 0)
    w = _randn((8, 8, shape[-1], d), 0.02, 1)
    bias = _randn((d,), 0.1, 2, torch.float32)
    reset_launch_counts()
    got = patch_embed(x, w, bias, 8)
    again = patch_embed(x, w, bias, 8)
    assert launches["patch_embed"] == 2
    assert got.shape == (shape[0], (shape[1] // 8) * (shape[2] // 8), d)
    want = patch_embed_plain(x, w, bias, 8)
    assert _rel(got, want) < PATCH_LIMIT
    assert _share(got, want) < PATCH_SHARE, _share(got, want)
    assert torch.equal(got, again)  # deterministic
    ctrl = patch_embed_plain(x, w.transpose(0, 1).contiguous(), bias, 8)  # w read as [dx, dy]
    assert _rel(got, ctrl) >= PATCH_LIMIT
    rounded = (patch_embed_plain(x, w, torch.zeros_like(bias), 8).float() + bias).bfloat16()
    assert _share(got, rounded) >= PATCH_SHARE, _share(got, rounded)


def test_patch_embed_refuses(dev):
    """Widths the kernel is not built for, more than 96 tokens a patch row,
    P*C not a multiple of 8."""
    x = _randn((1, 8, 8, 128), 1.0, 0)
    with pytest.raises(ValueError):
        patch_embed(x, _randn((8, 8, 128, 256), 0.02, 1), torch.zeros(256, device="cuda"), 8)
    with pytest.raises(ValueError):
        patch_embed(_randn((1, 8, 776, 128), 1.0, 0), _randn((8, 8, 128, D), 0.02, 1),
                    torch.zeros(D, device="cuda"), 8)
    with pytest.raises(ValueError):
        patch_embed(_randn((1, 4, 8, 3), 1.0, 0), _randn((4, 4, 3, D), 0.02, 1),
                    torch.zeros(D, device="cuda"), 4)


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


def _ln_dense_dx_moved(x, g, b, w, bias, dy, gelu):
    """Control fault for dx's share: with GELU, dg kept in f32 before the
    dxn product; without it (dg = dy, already bf16), dxn rounded to bf16
    before the LN backward (the kernel and JAX keep it in f32)."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-6)
    xhat = xc * inv
    dg = dy.float()
    if gelu:
        from intentbev_torch.ops.fused_ln_mlp import gelu_erf_grad

        xn = (xhat * g + b).to(x.dtype).float()
        dg = dg * gelu_erf_grad(xn @ w.float().t() + bias)
    dxn = dg @ w.float()
    if not gelu:
        dxn = dxn.to(x.dtype).float()
    dyg = dxn * g
    dx = inv * (dyg - dyg.mean(-1, keepdim=True) - xhat * (dyg * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dout_x,gelu", LN_DENSE_CASES[:2])
@pytest.mark.parametrize("rows", LN_DENSE_ROWS)
def test_fused_ln_dense_bwd(dev, rows, dout_x, gelu, d, monkeypatch):
    """The Hopper backward (the row kernel, the dW product, the partial
    sums) against its plain version: every output's relative L2 (control:
    GELU' skipped, or without GELU the LN backward without its m2 term),
    dx's share of differing elements from 100 rows on (control: a rounding
    point moved, ``_ln_dense_dx_moved``), and two calls give the same bits."""
    _check_ln_dense_bwd(rows, 3 * d if dout_x == 3 else 192, gelu, d, monkeypatch)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("gelu", [None, "erf"])
@pytest.mark.parametrize("dout", LN_DENSE_NARROW)
@pytest.mark.parametrize("rows", [300, MAIN_ROWS])
def test_fused_ln_dense_bwd_narrow(dev, rows, dout, gelu, d, monkeypatch):
    """The backward at a Dout that is not a multiple of 192 (the dW
    product's last 128-row tile partial at 64 and 320): the checks of
    :func:`test_fused_ln_dense_bwd`."""
    _check_ln_dense_bwd(rows, dout, gelu, d, monkeypatch)


def _check_ln_dense_bwd(rows, dout, gelu, d, monkeypatch):
    x, g, b, w, bias = _ln_dense_inputs(rows, d, dout)
    dy = _randn((rows, dout), 1.0, 5)
    reset_launch_counts()
    got = fused_ln_dense_bwd(x, g, b, w, bias, dy, gelu_mode=gelu)
    again = fused_ln_dense_bwd(x, g, b, w, bias, dy, gelu_mode=gelu)
    assert launches["fused_ln_dense_bwd"] == 2
    assert [tuple(t.shape) for t in got] == [(rows, d), (d,), (d,), (dout, d), (dout,)]
    want = fused_ln_dense_bwd_plain(x, g, b, w, bias, dy, gelu_mode=gelu)
    assert max(_rels(got, want)) < LN_DENSE_BWD_LIMIT, _rels(got, want)
    if rows >= 100:
        assert _share(got[0], want[0]) < BWD_SHARE, _share(got[0], want[0])
        moved = _ln_dense_dx_moved(x, g, b, w, bias, dy, gelu)
        assert _share(got[0], moved) >= BWD_SHARE, _share(got[0], moved)
    assert all(torch.equal(a, c) for a, c in zip(got, again))  # deterministic
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


# The Hopper backward (TMA tile rings, wgmma): every form at both head dims
# on shapes that leave ragged 64- and 128-row tiles, one where a whole
# 128-key block lies past seq_len (T=400, seq_len 250), and the main path's.
# chunk 256 divides JAX's padded length at each T (768 rows; 4608 at 4501).
TMA_SHAPES = [(1, 300, 250), (2, 130, 130), (1, 400, 250), (8, 4501, 4501)]
OTHER_FORM = {"fused": "split", "split": "fused", "chunked": "split"}
MODES_OF_FORM = tuple(OTHER_FORM)


@pytest.mark.parametrize("b,t,seq_len", TMA_SHAPES)
@pytest.mark.parametrize("hd", [64, 32])
def test_flash_bwd_packed_forms(dev, hd, b, t, seq_len):
    """Each form against its plain version (limit of the forms), dk = dv = 0
    exactly past seq_len, the same bits from two calls; controls: delta left
    out and, at head dim 32, another form's rounding."""
    heads = D // hd
    qkv = _randn((b, t, 3 * D), 1.0, 0)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    do = _randn((b, t, D), 1.0, 1)
    o, lse = flash_attention_packed(q, k, v, heads, seq_len)
    for form in MODES_OF_FORM:
        args = (q, k, v, o, lse, do, heads, seq_len, form, 256)
        reset_launch_counts()
        got = _packed_bwd_parts(flash_attention_packed_bwd, *args)
        again = _packed_bwd_parts(flash_attention_packed_bwd, *args)
        assert launches[tfp.BWD_COUNTERS[form]] == 2 and sum(launches.values()) == 2
        assert all(torch.equal(a, c) for a, c in zip(got, again)), form
        assert not got[1][:, seq_len:].any() and not got[2][:, seq_len:].any()
        want = _packed_bwd_parts(flash_attention_packed_bwd_plain, *args)
        assert max(_rels(got, want)) < ROW11_LIMIT, (form, _rels(got, want))
        ctrl = _packed_bwd_parts(flash_attention_packed_bwd_plain, q, k, v,
                                 torch.zeros_like(o), *args[4:])
        assert max(_rels(got, ctrl)) >= ROW11_LIMIT, form
        if hd == 32:
            ctrl = _packed_bwd_parts(flash_attention_packed_bwd_plain, *args[:8],
                                     OTHER_FORM[form], 256)
            assert max(_rels(got, ctrl)) >= ROW11_LIMIT, (form, _rels(got, ctrl))


@pytest.mark.parametrize("b,t,seq_len", TMA_SHAPES)
@pytest.mark.parametrize("hd", [64, 32])
def test_flash_bwd_bhtd_tiles(dev, hd, b, t, seq_len):
    """The BHTD backward on contiguous [B, 3, T, D]: against its plain
    version, dk = dv = 0 exactly past seq_len, the same bits from two calls;
    control: delta left out."""
    q, k, v, do = (_randn((b, 3, t, hd), 1.0, s) for s in range(4))
    o, lse = flash_attention_fwd_plain(q, k, v, seq_len)
    reset_launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, seq_len)
    again = flash_attention_bwd(q, k, v, o, lse, do, seq_len)
    assert launches["flash_attention_bwd"] == 2 and sum(launches.values()) == 2
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert not got[1][:, :, seq_len:].any() and not got[2][:, :, seq_len:].any()
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, seq_len)
    assert max(_rels(got, want)) < FLASH_BWD_LIMIT, _rels(got, want)
    ctrl = flash_attention_bwd_plain(q, k, v, torch.zeros_like(o), lse, do, seq_len)
    assert max(_rels(got, ctrl)) >= FLASH_BWD_LIMIT


def test_flash_bwd_refuses_what_tma_cannot_take(dev):
    """Views whose base address is not a multiple of 16 bytes raise before
    any launch, in the forward and backward entries of both layouts (every
    flash kernel reads q, k and v through TMA)."""
    qkv = _randn((1, 130, 3 * D + 8), 1.0, 0)
    q, k, v = (qkv[..., 1 + j * D:1 + (j + 1) * D] for j in range(3))  # 2 bytes off
    do, o = _randn((1, 130, D), 1.0, 1), _randn((1, 130, D), 1.0, 2)
    lse = torch.zeros(1, 6, 130, device="cuda")
    reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_packed_bwd(q, k, v, o, lse, do, 6)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_packed(q, k, v, 6)
    views = [heads_view(x, 6) for x in (q, k, v, o, do)]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(*views[:4], lse, views[4])
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(*views[:3])
    assert sum(launches.values()) == 0


# The Hopper forward (a TMA ring of k and v tiles, wgmma) in JAX's three
# softmax forms: each against its plain version in the same form, by the
# relative L2 (FLASH_LIMIT) and by the share of o's elements that differ
# (FWD_SHARE_LIMIT; chip_smoke.py phases 3 and 11 and PERF.md have the sound
# and control readings it lies between), lse, the same bits from two calls,
# each form counted under its own name; control: the plain version of
# another form (the monolithic safe one for the chunked form where a chunk
# holds fewer keys than seq_len, else the fixed max).
FWD_SHARE_LIMIT = 0.02
FWD_FORMS = {"safe": (0, False), "fixed": (256, True), "chunked": (256, False)}


def _share(got, want):
    return float((got != want).float().mean())


@pytest.mark.parametrize("b,t,seq_len", TMA_SHAPES)
@pytest.mark.parametrize("hd", [64, 32])
def test_flash_fwd_forms(dev, hd, b, t, seq_len):
    heads = D // hd
    qkv = _randn((b, t, 3 * D), 1.0, 0)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    plain = {form: flash_attention_packed_plain(q, k, v, heads, seq_len, *args)
             for form, args in FWD_FORMS.items()}
    other = {"safe": "fixed", "fixed": "safe", "chunked": "safe" if seq_len > 256 else "fixed"}
    for form, args in FWD_FORMS.items():
        reset_launch_counts()
        o, lse = flash_attention_packed(q, k, v, heads, seq_len, *args)
        again = flash_attention_packed(q, k, v, heads, seq_len, *args)
        assert launches[tfp.FWD_COUNTERS[form]] == 2 and sum(launches.values()) == 2
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1]), form
        o_p, lse_p = plain[form]
        assert _rel(o, o_p) < FLASH_LIMIT and _share(o, o_p) < FWD_SHARE_LIMIT, (
            form, _rel(o, o_p), _share(o, o_p))
        assert float((lse - lse_p).abs().max()) < LSE_LIMIT, form
        assert _share(o, plain[other[form]][0]) >= FWD_SHARE_LIMIT, (form, other[form])


def test_flash_fwd_bhtd_is_the_safe_form(dev):
    """The BHTD forward takes the true row max (JAX's BHTD kernel): on the
    same heads it gives the packed safe kernel's bits; control: the packed
    fixed-max form differs."""
    qkv = _randn((2, 300, 3 * D), 1.0, 0)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    o_b, lse_b = flash_attention_packed_layout(q, k, v, 6, 250)
    o_s, lse_s = flash_attention_packed(q, k, v, 6, 250)
    assert torch.equal(o_b, o_s) and torch.equal(lse_b, lse_s)
    assert _share(o_b, flash_attention_packed(q, k, v, 6, 250, 0, True)[0]) >= FWD_SHARE_LIMIT


def test_flash_fwd_chunk_off_the_key_tile_raises(dev):
    """A chunk that divides JAX's padded length but is not a whole number of
    the kernel's 128-key tiles raises on CUDA, naming it."""
    x = _randn((1, 300, D), 1.0, 0)
    with pytest.raises(ValueError, match="kv_chunk 192"):
        flash_attention_packed(x, x, x, 6, None, 192)


# Rows 18 and 19 (limits those of chip_smoke.py phase 13). The int8 kernel
# computes the plain version's integer products exactly; they differ only
# where denom's f32 sum order tips o to the neighbouring bf16 (or moves it
# by an ulp in f32). Control: P's codes rounded against a running max over
# 64-key tiles (an online softmax). On an H100 at the attention sublayer's
# shape: <= 2e-5 (bf16) and <= 1e-7 (f32) against the control's >= 3e-2.
FLASH_INT8_LIMIT = 2e-3
# The projection: f32 sums in another order under one bf16 rounding.
# Controls: the forward with the Dense output rounded to bf16 before the
# gate and the residual (the model's unfused rounding); the backward with
# db summed from the rounded dyg_c (with a gate; without one dyg_c = dy, and
# the control is dW rounded to bf16). On an H100 at the attention
# sublayer's shape: forward 3.1e-5 against the control's 2.2e-3; backward dx
# 4.1e-5, dW 1.7e-6, db 2.9e-7, the control's db 1.9e-3.
PROJ_LIMIT = 3e-4
PROJ_BWD_LIMITS = (1e-3, 1e-4, 1e-4)  # dx, dW, db


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [24, 12, 6, 3])
@pytest.mark.parametrize("b,t,seq_len", [(1, 300, 250), (8, 4608, 4501)])
def test_flash_int8(dev, b, t, seq_len, heads, dtype):
    """Int8 attention on qkv slices at head dims 16 to 128 over 384 lanes,
    bf16 and f32, against its plain version; one launch counted, and two
    calls give the same bits."""
    qkv = _randn((b, t, 3 * D), 1.0, 0, dtype)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    reset_launch_counts()
    got = flash_attention_packed_int8(q, k, v, heads, seq_len)
    assert launches["flash_int8"] == 1 and sum(launches.values()) == 1
    assert got.dtype == dtype and got.shape == (b, t, D)
    assert torch.equal(flash_attention_packed_int8(q, k, v, heads, seq_len), got)
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


def test_flash_int8_refusals(dev):
    """What the card's entry still refuses: head dim 8 (JAX takes it; the
    kernels start at 16), heads that do not pair into 128 lanes, tensors on
    two devices, and mixed dtypes."""
    x = _randn((1, 64, 128), 1.0, 0)
    with pytest.raises(ValueError, match="head dim 8"):
        flash_attention_packed_int8(x, x, x, 16)
    x3 = _randn((1, 64, 192), 1.0, 0)
    with pytest.raises(ValueError, match="pair"):
        flash_attention_packed_int8(x3, x3, x3, 3)
    with pytest.raises(ValueError, match="must be"):
        flash_attention_packed_int8(x, x.cpu(), x, 2)
    with pytest.raises(ValueError, match="must be"):
        flash_attention_packed_int8(x, x.float(), x, 2)


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


# y's and dx's shares of differing elements (wgmma's f32 sums in another
# order than the plain version's tip a few to the neighbouring bf16); the
# forward's control moves most of y.
PROJ_SHARE = 2e-2
PROJ_WIDTHS = [(384, 384), (384, 192), (192, 384), (192, 192)]  # (d_in, d_out)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("n,d_in,d_out", [(600, 384, 192), (600, 192, 384),
                                          (8 * 4608, 384, 384)] + [
    (n, d_in, d_out) for n in (1, 300, 4501, 8 * 4608) for d_in, d_out in PROJ_WIDTHS
    if (n, d_in, d_out) != (8 * 4608, 384, 384)])
def test_fused_proj(dev, n, d_in, d_out, gated):
    """The forward and the backward kernels (row 19: wgmma fed by TMA; dW on
    dw_gemm_kernel, db on col_sums_kernel) against their plain versions,
    from 1 row to the padded attention rows, every width pair; one launch
    each, and two calls give the same bits."""
    x, w, bias, r, gate = _proj_args(n, d_in, d_out, gated)
    reset_launch_counts()
    y = fused_proj_fwd(x, w, bias, r, gate)
    assert launches["fused_proj"] == 1 and sum(launches.values()) == 1
    want_y = fused_proj_fwd_plain(x, w, bias, r, gate)
    assert _rel(y, want_y) < PROJ_LIMIT and _share(y, want_y) < PROJ_SHARE
    ctrl_y = _proj_unfused(x, w, bias, r, gate)
    assert _rel(y, ctrl_y) >= PROJ_LIMIT and _share(y, ctrl_y) >= PROJ_SHARE
    assert torch.equal(y, fused_proj_fwd(x, w, bias, r, gate))
    dy = _randn((n, d_out), 1.0, 5)
    got = fused_proj_bwd(x, w, dy, gate)
    assert launches["fused_proj_bwd"] == 1
    want = fused_proj_bwd_plain(x, w, dy, gate)
    assert all(r_ < lim for r_, lim in zip(_rels(got, want), PROJ_BWD_LIMITS)), _rels(got, want)
    assert _share(got[0], want[0]) < PROJ_SHARE
    if gated:  # control: db from the rounded dyg_c
        ctrl = (want[0], want[1], (dy.float() * gate).bfloat16().float().sum(0))
    else:  # dyg_c = dy, so no rounding point moves; control: dW rounded to bf16
        ctrl = (want[0], want[1].bfloat16(), want[2])
    assert any(r_ >= lim for r_, lim in zip(_rels(got, ctrl), PROJ_BWD_LIMITS))
    assert all(torch.equal(a, b) for a, b in zip(got, fused_proj_bwd(x, w, dy, gate)))


def test_tma_entry_on_a_new_host_thread(dev):
    """A TMA entry whose first CUDA call on a host thread is its own (as on
    autograd's worker while the allocator serves every tensor from its
    cache): the tensor-map encoder needs a context current on the thread,
    which the entry binds; the thread's call gives the main thread's bits."""
    x, w, bias, r, gate = _proj_args(600, 384, 384, True)
    dy = _randn((600, 384), 1.0, 5)
    want = [t.cpu() for t in fused_proj_bwd(x, w, dy, gate)]  # frees its outputs to the cache
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["got"] = [t.cpu() for t in fused_proj_bwd(x, w, dy, gate)]
        except RuntimeError as e:
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "error" not in out, out.get("error")
    assert all(torch.equal(a, b) for a, b in zip(out["got"], want))


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
