"""The two patch-embed kernels' bf16 rounding points against the JAX package, on the CPU.

Row 15, ``intentbev/ops/patch_embed.py::_kernel``: tokens are the f32 sum
over (dy, dx, c) of x * W, plus the f32 bias, rounded once to x's dtype. Row
1, ``intentbev/ops/voxel_embed.py::_kernel``: each occupied cell's value is
rounded to the kernel's dtype (the TPU kernel's bf16 band), its product with
W's row summed in f32 into its token, plus the bias, rounded once. The
port's plain versions (the CPU path, and the card's oracle for the kernels
of ``csrc/patch_embed.cu`` and ``csrc/voxel_embed.cu``) are held here
against JAX's kernels in bf16, in interpret mode, compiled with
``xla_allow_excess_precision`` off, at D = 384 and 192 with C = 290 (P*C =
2320, the K edge of the Hopper kernel). Inputs come from a numpy seed; the
chunks are built here, one cell per (pixel, channel) as the host build
guarantees, with non-integral values (integers up to 256 are exact in bf16,
so they would hide the value's rounding point).

Readings: the share of the tokens' elements that differ (for row 1 over the
tokens that take a hit; the others are the bias), limit ``SHARE`` =
1 % (f32 summation order tips a few values to the neighbouring bf16: sound
readings 0-0.03 %, printed by ``-s``). Each case's control moves one
rounding point and must exceed the limit: row 15 the sum rounded to bf16
before the bias (25.6-26.8 %); row 1 the cell value not rounded before its
product (39.1-42.7 %). Row 1 also runs a band whose ~3000 hits all fall in
one token.

Row 1's first kernel writes a token-ordered hit list; its plain version
(``voxel_hits_plain``) is held against a numpy loop, entry for entry, on the
same chunks, a band filled to its capacity and a band whose chunks past
``count`` hold cells that must not be read among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev.ops import voxel_embed as jve  # noqa: E402
from intentbev.ops.patch_embed import patch_embed_matmul as jax_patch_embed  # noqa: E402
from intentbev_torch.ops import voxel_embed as tve  # noqa: E402
from intentbev_torch.ops.patch_embed import patch_embed_plain  # noqa: E402

SHARE = 1e-2  # limit on the share of the tokens' elements that differ
P = 8
C = 290
WIDTHS = [384, 192]
HW = (80, 80)  # two bands of five patch rows, ten tokens a patch row
NC = 64


def _compile(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)


def _bf16(a):
    """f32 values a bf16 holds (numpy)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _share(got, want):
    return float((got != want).float().mean())


# -- row 15 -------------------------------------------------------------------

@pytest.mark.parametrize("d", WIDTHS)
def test_patch_embed_rounding_points(d):
    """Two samples of 5 x 10 patches (one band of five patch rows in JAX)."""
    rng = np.random.default_rng(0)
    x = _bf16(rng.normal(0, 1, (2, 40, 80, C)))
    kern = _bf16(rng.normal(0, 0.02, (P, P, C, d)))
    bias = rng.normal(0, 0.1, d).astype(np.float32)
    want = _compile(lambda x, k, b: jax_patch_embed(x, k, b, P), jnp.asarray(x, jnp.bfloat16),
                    jnp.asarray(kern, jnp.bfloat16), jnp.asarray(bias))
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    xt, kt, bt = (torch.from_numpy(a) for a in (x, kern, bias))
    got = patch_embed_plain(xt.bfloat16(), kt.bfloat16(), bt, P)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 50, d)
    sound = _share(got.float(), want)
    # control: the f32 sum rounded to bf16 before the bias
    ctrl = patch_embed_plain(xt.bfloat16(), kt.bfloat16(), torch.zeros_like(bt), P)
    ctrl = (ctrl.float() + bt).bfloat16()
    print(f"row 15 D={d}: share {sound:.4%}, control {_share(ctrl.float(), want):.4%}")
    assert sound < SHARE
    assert _share(ctrl.float(), want) >= SHARE


# -- row 1 --------------------------------------------------------------------

def _band_geometry(hw=HW):
    h, w = hw
    rpp = jve.rows_per_program(h, P)
    return h // (rpp * P), rpp * P * w


def _chunk_cells(rng, cells, nc, band_px):
    """One band's cells (unique (pixel, channel) pairs; channel may lie
    outside [0, C)) -> wid [nc], sl/ch/val [nc, 64], count: the cells grouped
    by window in a random order, each window's cells cut into chunks of 64."""
    px, ch = cells
    order = rng.permutation(px.size)
    px, ch = px[order], ch[order]
    win = px // jve.WINDOW
    wid = np.zeros(nc, np.int32)
    sl = np.zeros((nc, jve.CAP), np.int32)
    chs = np.zeros((nc, jve.CAP), np.int32)
    val = np.zeros((nc, jve.CAP), np.float32)
    n = 0
    for wv in np.unique(win):
        idx = np.nonzero(win == wv)[0]
        for s in range(0, idx.size, jve.CAP):
            part = idx[s:s + jve.CAP]
            assert n < nc, "more chunks than the capacity"
            wid[n] = wv
            sl[n, :part.size] = px[part] % jve.WINDOW
            chs[n, :part.size] = ch[part]
            val[n, :part.size] = rng.uniform(0.5, 255.0, part.size)
            n += 1
    assert band_px % jve.WINDOW == 0
    return wid, sl, chs, val, n


def _chunks(rng, bands, nc=NC, hw=HW):
    """bands[b][band]: (pixels within the band, channels) -> numpy chunks."""
    nb, band_px = _band_geometry(hw)
    b = len(bands)
    wid = np.zeros((b, nb, nc), np.int32)
    sl, ch = (np.zeros((b, nb, nc, 1, jve.CAP), np.int32) for _ in range(2))
    val = np.zeros((b, nb, nc, 1, jve.CAP), np.float32)
    count = np.zeros((b, nb), np.int32)
    for i, sample in enumerate(bands):
        for j, cells in enumerate(sample):
            if cells is None:
                continue
            wid[i, j], sl[i, j, :, 0], ch[i, j, :, 0], val[i, j, :, 0], count[i, j] = \
                _chunk_cells(rng, cells, nc, band_px)
    return tve.VoxelChunks(wid, sl, ch, val, count)


def _random_cells(rng, n, band_px, pixels=None):
    """n unique (pixel, channel) cells of a band, anywhere or within the
    pixels ``pixels``."""
    pixels = np.arange(band_px) if pixels is None else pixels
    flat = rng.choice(pixels.size * C, n, replace=False)
    return pixels[flat // C], (flat % C).astype(np.int32)


def _one_patch_pixels(hw=HW, pr=2, pc=3):
    """The pixels of the patch at patch row pr, column pc of a band."""
    w = hw[1]
    r, c = np.meshgrid(np.arange(P), np.arange(P), indexing="ij")
    return ((pr * P + r) * w + pc * P + c).ravel()


def _case(name, rng):
    nb, band_px = _band_geometry()
    if name == "spread":  # two bands of sample 0, one cell's channel C; sample 1 empty
        px, ch = _random_cells(rng, 1500, band_px)
        ch[7] = C
        bands = [[(px, ch), _random_cells(rng, 1200, band_px)], [None] * nb]
    else:  # ~3000 hits in one token of band 1
        bands = [[None, _random_cells(rng, 3000, band_px, _one_patch_pixels())]]
    return _chunks(rng, bands)


def _to_torch(chunks):
    return tve.VoxelChunks(*(torch.from_numpy(np.ascontiguousarray(a)) for a in chunks))


def _unrounded(chunks, kern, bias):
    """Control: voxel_embed_tokens_plain with each cell value kept in f32
    before its product."""
    _, nb, _ = chunks.wid.shape
    t_band = HW[0] // nb // P * (HW[1] // P)
    d = kern.shape[-1]
    band, tok, wrow, val = tve._hit_cells(chunks, C, P, HW)
    out = bias.float().expand(chunks.wid.shape[0] * nb * t_band, d).clone()
    out.index_add_(0, band * t_band + tok, kern.reshape(-1, d)[wrow].float() * val[:, None])
    return out.bfloat16().reshape(chunks.wid.shape[0], nb * t_band, d)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("case", ["spread", "one_patch"])
def test_voxel_embed_rounding_points(case, d):
    rng = np.random.default_rng(1)
    chunks = _case(case, rng)
    kern = _bf16(rng.normal(0, 0.05, (P, P, C, d)))
    bias = rng.normal(0, 0.1, d).astype(np.float32)
    want = _compile(lambda ch, k, b: jve.voxel_embed_tokens(ch, k, b, P, HW),
                    jve.VoxelChunks(*(jnp.asarray(a) for a in chunks)),
                    jnp.asarray(kern, jnp.bfloat16), jnp.asarray(bias))
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    ct = _to_torch(chunks)
    kt, bt = torch.from_numpy(kern).bfloat16(), torch.from_numpy(bias)
    got = tve.voxel_embed_tokens_plain(ct, kt, bt, P, HW)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # read over the tokens with a hit (the others are the bias on every side)
    counts = tve.voxel_hits_plain(ct, C, P, HW).offsets.diff(dim=-1)
    hit = counts.reshape(got.shape[0], -1) > 0
    sound = _share(got.float()[hit], want[hit])
    ctrl = _share(_unrounded(ct, kt, bt).float()[hit], want[hit])
    print(f"row 1 {case} D={d}: share {sound:.4%}, control {ctrl:.4%}")
    assert sound < SHARE
    assert ctrl >= SHARE
    if case == "spread":  # the empty sample is the bias
        assert torch.equal(got[1].float(), bt.bfloat16().float().expand_as(got[1]))
    else:  # one token takes every hit
        assert int(hit.sum()) == 1 and int(counts.max()) > 2500


def _hits_numpy(chunks, channels=C, hw=HW):
    """The token-ordered hit list as a loop: each band's cells in chunk
    order, then cell order, appended to their token's list."""
    wid, sl, ch, val, count = (np.asarray(a) for a in chunks)
    b, nb, nc = wid.shape
    h, w = hw
    rpp = jve.rows_per_program(h, P)
    gw, band_px = w // P, rpp * P * w
    t_band = rpp * gw
    vb = _bf16(val)
    offsets = np.zeros((b, nb, t_band + 1), np.int32)
    wrow = np.zeros((b, nb, nc * jve.CAP), np.int32)
    vals = np.zeros((b, nb, nc * jve.CAP), np.float32)
    for i in range(b):
        for j in range(nb):
            lists = [[] for _ in range(t_band)]
            for k in range(min(int(count[i, j]), nc)):
                for cell in range(jve.CAP):
                    v, c = val[i, j, k, 0, cell], int(ch[i, j, k, 0, cell])
                    px = int(wid[i, j, k]) * jve.WINDOW + int(sl[i, j, k, 0, cell])
                    if v != 0 and 0 <= c < channels and 0 <= px < band_px:
                        rib, col = divmod(px, w)
                        lists[(rib // P) * gw + col // P].append(
                            (((rib % P) * P + col % P) * channels + c, vb[i, j, k, 0, cell]))
            pos = 0
            for t, entries in enumerate(lists):
                offsets[i, j, t] = pos
                for r, v in entries:
                    wrow[i, j, pos], vals[i, j, pos] = r, v
                    pos += 1
            offsets[i, j, t_band] = pos
    return offsets, wrow, vals


def _full_band_case(rng):
    """Band 0 filled to its capacity (nc chunks of 64 cells); band 1 with
    count 3 below the 8 chunks it holds, whose cells must not be read."""
    _, band_px = _band_geometry()
    nc = 16
    first_windows = np.arange(8 * jve.WINDOW)  # band 1: 8 chunks of ~50 cells
    chunks = _chunks(rng, [[None, _random_cells(rng, 400, band_px, first_windows)]], nc)
    wid, sl, ch, val, count = (np.array(a) for a in chunks)
    for k in range(nc):  # window k: 64 cells of distinct channels
        wid[0, 0, k] = k
        sl[0, 0, k, 0] = rng.integers(0, jve.WINDOW, jve.CAP)
        ch[0, 0, k, 0] = rng.permutation(C)[:jve.CAP]
        val[0, 0, k, 0] = rng.uniform(0.5, 255.0, jve.CAP)
    count[0, 0] = nc
    assert count[0, 1] > 3
    count[0, 1] = 3
    return tve.VoxelChunks(wid, sl, ch, val, count)


@pytest.mark.parametrize("case", ["spread", "one_patch", "full_band"])
def test_voxel_hits_plain_matches_numpy(case):
    rng = np.random.default_rng(2)
    chunks = _full_band_case(rng) if case == "full_band" else _case(case, rng)
    want = _hits_numpy(chunks)
    got = tve.voxel_hits_plain(_to_torch(chunks), C, P, HW)
    np.testing.assert_array_equal(got.offsets.numpy(), want[0])
    np.testing.assert_array_equal(got.wrow.numpy(), want[1])
    np.testing.assert_array_equal(got.val.numpy(), want[2])
    assert int(want[0][..., -1].sum()) > 0
