"""The packed attention's three backwards (fused, split, chunked) and its
head-dim-32 path against the JAX package, on the CPU; the bench twins.

The JAX side is ``intentbev/ops/flash_packed.py``'s ``_fwd`` and ``_bwd``
in interpret mode, traced afresh after ``BWD_FUSED`` and ``BWD_KV_CHUNK``
are patched on the module (as ``tests/test_flash_packed.py`` patches them)
and compiled with ``xla_allow_excess_precision`` off: XLA's CPU backend
otherwise keeps a bf16 product in f32 where a dot consumes it (it does so
for the fused kernel's ``t^T qh``, moving 39 % of dk's elements), which the
TPU's bf16 matrix unit cannot. The port side is the plain versions, fed the
same numpy inputs; the backward is fed JAX's o and lse. B=1, T=300 with
keys past 283 masked; JAX pads T to 768, so chunk 256 takes the chunked
kernels there.

Tolerances: f32, 1e-5 of the largest value (the same f32 sums in another
order); bf16, both sides round the same f32 values at the same points, so
a value differs only where the summation order tips it to the neighbouring
bf16: at most 1.6e-2 of the largest value, and at most 0.3 % of the
elements of o, dq, dk and dv may differ (sound readings <= 0.06 %). At head
dim 32 the three forms round differently: the port's fused backward
against JAX's split differs in 39 % of dk, split against chunked in 56 % of
dk and 57 % of dv, and the forward with the f32 scale in 23 % of o; the
controls show that the check sees each. At head dim 64 the scale is 1/8
and the three forms give identical values.
"""

import ast
import contextlib
import dataclasses
import importlib
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev.bev import voxelize as jvox  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.bev import voxelize as tvox  # noqa: E402
from intentbev_torch.bev.augment import draw_dropout  # noqa: E402
from intentbev_torch.boxes import generate_anchors  # noqa: E402
from intentbev_torch.models import build_model, init_params  # noqa: E402
from intentbev_torch.synthetic import train_batch  # noqa: E402
from intentbev_torch.train import StepDraws, make_train_step  # noqa: E402
from test_torch_train import check_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
import bench_torch  # noqa: E402
import bench_train_torch  # noqa: E402
jfp = importlib.import_module("intentbev.ops.flash_packed")
jvit = importlib.import_module("intentbev.models.vit")
tfp = importlib.import_module("intentbev_torch.ops.flash_packed")

B, T, SEQ_LEN, DM = 1, 300, 283, 128
CHUNK = 256  # divides JAX's padded 768 rows
MODES = {"fused": (True, 0), "split": (False, 0), "chunked": (False, CHUNK)}
BF16_REL, BF16_SHARE = 1.6e-2, 3e-3
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@contextlib.contextmanager
def jax_bwd_form(fused: bool, chunk: int):
    """JAX's backward form: its module constants patched, then restored."""
    old = jfp.BWD_FUSED, jfp.BWD_KV_CHUNK
    jfp.BWD_FUSED, jfp.BWD_KV_CHUNK = fused, chunk
    try:
        yield
    finally:
        jfp.BWD_FUSED, jfp.BWD_KV_CHUNK = old


def _inputs(rng, dtype):
    """q, k, v, do f32 [B, T, 128], exactly representable in ``dtype``."""
    jdt = DTYPES[dtype][0]
    return [np.asarray(jnp.asarray(rng.normal(0, 1, (B, T, DM)), jdt).astype(jnp.float32))
            for _ in range(4)]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX results computed so far in this module, by their arguments:
    several tests hold the port against the same JAX trace on the same
    inputs (a compile of the interpret-mode kernels each)."""
    return {}


def _jax_packed(q, k, v, do, heads, dtype, mode, runs=None):
    """JAX's o, lse and (dq, dk, dv) of the packed kernels in ``mode``, cut
    to T rows; with ``runs`` (:func:`jax_runs`), computed once per set of
    arguments."""
    if runs is not None:
        key = (heads, dtype, mode, *(a.tobytes() for a in (q, k, v, do)))
        if key not in runs:
            runs[key] = _jax_packed(q, k, v, do, heads, dtype, mode)
        return runs[key]
    jdt = DTYPES[dtype][0]
    dh = DM // heads
    t_pad = jfp._pad_len(T, 768)

    def pad(x):
        return jnp.pad(jnp.asarray(x, jdt), ((0, 0), (0, t_pad - T), (0, 0)))

    def fwd_bwd(q3, k3, v3, do3):  # a fresh function: traced under the patch
        o3, lse = jfp._fwd(q3, k3, v3, heads, 1.0 / dh ** 0.5, SEQ_LEN)
        return o3, lse, jfp._bwd(heads, 1.0 / dh ** 0.5, SEQ_LEN, (q3, k3, v3, o3, lse), do3)

    args = [pad(a) for a in (q, k, v, do)]
    with jax_bwd_form(*MODES[mode]), pltpu.force_tpu_interpret_mode():
        compiled = jax.jit(fwd_bwd).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        o, lse, grads = compiled(*args)

    def cut(a):
        return np.asarray(a.astype(jnp.float32))[:, :T]
    return cut(o), np.asarray(lse)[:, :, :T, 0], [cut(g) for g in grads]


def _port_bwd(q, k, v, o, lse, do, heads, dtype, mode):
    tdt = DTYPES[dtype][1]
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v, o, do)]
    dqkv = tfp.flash_attention_packed_bwd_plain(*t[:4], torch.from_numpy(lse), t[4], heads,
                                                SEQ_LEN, *MODES[mode]).float().numpy()
    return [dqkv[..., j * DM:(j + 1) * DM] for j in range(3)]


def _differ(got, want, name, rel, share):
    """max|got - want| <= rel * max|want|, and at most ``share`` of the
    elements differ at all."""
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{name}: {err} vs {np.abs(want).max()}"
    frac = float((got != want).mean())
    assert frac <= share, f"{name}: {frac:.4f} of the elements differ"
    return frac


def _limits(dtype):
    return (1e-5, 1.0) if dtype == "f32" else (BF16_REL, BF16_SHARE)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dh", [64, 32])
def test_packed_backward_matches_jax(rng, jax_runs, dh, dtype, mode):
    """dq, dk and dv of the plain backward in each form against JAX's
    ``_bwd`` with its constants patched; padded keys' dk and dv exactly 0."""
    heads = DM // dh
    q, k, v, do = _inputs(rng, dtype)
    o, lse, want = _jax_packed(q, k, v, do, heads, dtype, mode, jax_runs)
    got = _port_bwd(q, k, v, o, lse, do, heads, dtype, mode)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _differ(a, w, name, *_limits(dtype))
    assert not got[1][:, SEQ_LEN:].any() and not got[2][:, SEQ_LEN:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dh", [64, 32])
def test_packed_forward_matches_jax(rng, jax_runs, dh, dtype):
    """o and lse of the plain forward against JAX's ``_fwd``: at head dim 32
    q is scaled by 1/sqrt(32) rounded to bf16 (with the f32 scale 23 % of o
    differs)."""
    heads = DM // dh
    q, k, v, do = _inputs(rng, dtype)
    o, lse, _ = _jax_packed(q, k, v, do, heads, dtype, "fused", jax_runs)
    tdt = DTYPES[dtype][1]
    got_o, got_lse = tfp.flash_attention_packed_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), heads, SEQ_LEN)
    _differ(got_o.float().numpy(), o, "o", *_limits(dtype))
    np.testing.assert_allclose(got_lse.numpy(), lse, rtol=1e-5, atol=1e-5)


CONTROLS = {  # name: (JAX form, the port's form with the fault, output caught)
    "split with the fused dk rounding": ("split", "fused", "dk"),
    "chunked with split's scores": ("chunked", "split", "dk"),
    "fused with split's dk rounding": ("fused", "split", "dk"),
}


@pytest.mark.parametrize("control", list(CONTROLS))
def test_rounding_faults_are_seen(rng, jax_runs, control):
    """At head dim 32, bf16: the check of the backward fails for the plain
    version of another form (the form's fault), on the output named."""
    jax_mode, port_mode, caught = CONTROLS[control]
    q, k, v, do = _inputs(rng, "bf16")
    o, lse, want = _jax_packed(q, k, v, do, 4, "bf16", jax_mode, jax_runs)
    got = _port_bwd(q, k, v, o, lse, do, 4, "bf16", port_mode)
    i = ("dq", "dk", "dv").index(caught)
    with pytest.raises(AssertionError, match=caught):
        _differ(got[i], want[i], caught, BF16_REL, BF16_SHARE)


def test_forward_f32_scale_is_seen(rng, jax_runs, monkeypatch):
    """At head dim 32, bf16: the forward check fails for a plain forward
    that scales q by the f32 scale (the port's fault before this check)."""
    q, k, v, do = _inputs(rng, "bf16")
    o = _jax_packed(q, k, v, do, 4, "bf16", "fused", jax_runs)[0]
    monkeypatch.setattr(tfp, "scales", lambda dh, dtype: (dh ** -0.5, dh ** -0.5))
    got = tfp.flash_attention_packed_plain(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 4, SEQ_LEN)[0]
    with pytest.raises(AssertionError, match="o"):
        _differ(got.float().numpy(), o, "o", BF16_REL, BF16_SHARE)


def test_forms_coincide_at_head_dim_64(rng):
    """At head dim 64 (scale 1/8) the three plain backwards give the same
    bf16 values; at head dim 32 they do not."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(rng, "bf16"))
    for heads, same in ((2, True), (4, False)):
        o, lse = tfp.flash_attention_packed_plain(q, k, v, heads, SEQ_LEN)
        g = {m: tfp.flash_attention_packed_bwd_plain(q, k, v, o, lse, do, heads, SEQ_LEN, *f)
             for m, f in MODES.items()}
        assert torch.equal(g["fused"], g["split"]) is same
        assert torch.equal(g["split"], g["chunked"]) is same


def test_bwd_mode_follows_jax():
    """The form JAX's ``_bwd`` takes for a padded length: fused unless
    ``bwd_fused`` is off, then chunked where the chunk divides the length
    padded to 768 rows, else split; a chunk with ``bwd_fused`` on warns."""
    assert tfp.bwd_mode(4501, False, 1152) == "chunked"  # 4608 rows
    assert tfp.bwd_mode(4501, False, 1000) == "split"
    assert tfp.bwd_mode(4501, False, 0) == "split"
    assert tfp.bwd_mode(300, False, 256) == "chunked"  # 768 rows
    assert tfp.bwd_mode(tfp.pad_len(97, tfp.MODEL_PAD_ROWS), False, 512) == "split"
    with pytest.warns(UserWarning, match="bwd_fused"):
        assert tfp.bwd_mode(4501, True, 1152) == "fused"


def _packed_attention(q, k, v, use_flash=True, kv_len=None):
    """The JAX Attention's TPU branch on the CPU: [B, H, T, D] through the
    packed Pallas kernels (interpret mode) in the packed layout."""
    b, h, t, d = q.shape

    def packed(x):
        return jnp.transpose(x, (0, 2, 1, 3)).reshape(b, t, h * d)

    o = jfp.flash_attention_packed(packed(q), packed(k), packed(v), h, seq_len=kv_len)
    return jnp.transpose(o.reshape(b, t, h, d), (0, 2, 1, 3))


def _paired_32(cfg, **train):
    """tiny_test_config with 4 heads of 32 (they pair into 128 lanes), the
    flash path, drop-path 0, patch dropout always on."""
    vit = dataclasses.replace(cfg.vit, embed_dim=128, num_heads=4, use_flash_attention=True,
                              drop_path_rate=0.0)
    return dataclasses.replace(cfg, vit=vit, augment=dataclasses.replace(
        cfg.augment, dropout_prob=1.0), train=dataclasses.replace(cfg.train, **train))


@pytest.fixture(scope="module")
def jax_steps():
    """What the JAX step computes alike under every backward form (the
    initial state, the jitted step's metrics), by config and batch."""
    return {}


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_form_matches_jax(rng, monkeypatch, jax_steps, mode):
    """One tiny ViT step (4 heads of 32, f32) with the port's ``bwd_fused``
    / ``bwd_kv_chunk`` against ``intentbev.train.make_train_step`` traced
    with the constants patched and its attention through the packed
    kernels; the port's four attention backwards (2 streams x 2 blocks)
    take the form asked for."""
    taken = []
    bwd_mode = tfp.bwd_mode
    monkeypatch.setattr(tfp, "bwd_mode", lambda *a: taken.append(bwd_mode(*a)) or taken[-1])
    monkeypatch.setattr(jvit, "multi_head_attention", _packed_attention)
    fused, chunk = MODES[mode]
    with jax_bwd_form(fused, chunk), pltpu.force_tpu_interpret_mode():
        check_train_step(rng, _paired_32(jcfg.tiny_test_config()),
                         _paired_32(tcfg.tiny_test_config()),
                         dict(bwd_fused=fused, bwd_kv_chunk=chunk), jax_steps)
    assert taken == [mode] * 4


def test_remat_equals_no_remat():
    """``remat_vit_blocks``: the port's step (drop-path 0.2) gives the same
    loss and the same gradients (the blocks run again in the backward, on
    the gates already drawn)."""
    cfg = _paired_32(tcfg.tiny_test_config())
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, drop_path_rate=0.2))
    g = cfg.grid
    params = init_params(cfg, seed=0)
    anchors = torch.from_numpy(generate_anchors(g, cfg.anchors))
    batch = {k: torch.from_numpy(a) for k, a in train_batch(
        g, 2, 500, cfg.loss.max_gt_boxes, seed=0).items()}
    gen = torch.Generator().manual_seed(0)
    draws = StepDraws(draw_dropout(cfg.augment, g.height_px, g.width_px, 2, gen, "cpu"),
                      torch.rand(2 * anchors.shape[0], generator=gen))
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat_vit_blocks=remat))
        model = build_model(c)
        model.load_state_dict(params)
        step = make_train_step(model, c, anchors, torch.optim.SGD(model.parameters(), lr=0.0))
        metrics = step(batch, torch.Generator().manual_seed(1), draws)
        out.append((float(metrics["loss"]),
                    {k: p.grad.clone() for k, p in model.named_parameters()}))
    (loss0, g0), (loss1, g1) = out
    assert loss0 == loss1
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7, msg=k)


def test_remat_matches_jax(rng):
    """The step under ``remat_vit_blocks`` on both sides (``nn.remat`` in
    JAX, ``torch.utils.checkpoint`` in the port), on the flash path (JAX's
    interpret-mode kernels carry effects ``nn.remat`` cannot trace, so its
    CPU attention is the XLA one here, as in ``test_torch_train.py``)."""
    check_train_step(rng, _paired_32(jcfg.tiny_test_config(), remat_vit_blocks=True),
                     _paired_32(tcfg.tiny_test_config(), remat_vit_blocks=True),
                     dict(remat=True))


def test_cells_transport_matches_jax(rng):
    """``dedup_cells_host`` identical to JAX's; ``voxelize_cells`` identical
    to JAX's and to the points transport's voxelizer."""
    g = tcfg.tiny_test_config().grid
    pts = np.zeros((2, g.lidar_sweeps, 700, 4), np.float32)
    pts[..., 0] = rng.uniform(g.bev_x_min - 3, g.bev_x_max + 3, pts.shape[:3])
    pts[..., 1] = rng.uniform(g.bev_y_min - 3, g.bev_y_max + 3, pts.shape[:3])
    pts[..., 2] = rng.uniform(-2.5, 4.2, pts.shape[:3])
    pts[..., 3] = rng.uniform(-5, 255, pts.shape[:3])
    valid = rng.uniform(size=pts.shape[:3]) < 0.9
    jg = jcfg.tiny_test_config().grid
    ids, vals = zip(*(tvox.dedup_cells_host(p, v, g) for p, v in zip(pts, valid)))
    for i in range(2):
        want = jvox.dedup_cells_host(pts[i], valid[i], jg)
        np.testing.assert_array_equal(ids[i], want[0])
        np.testing.assert_array_equal(vals[i], want[1])
    got = tvox.voxelize_cells(torch.from_numpy(np.stack(ids)), torch.from_numpy(np.stack(vals)), g)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jvox.voxelize_cells(ids[i], vals[i], jg)))
    np.testing.assert_array_equal(got.numpy(), tvox.voxelize_packed(
        torch.from_numpy(pts), torch.from_numpy(valid), g).numpy())


def _bench_py_lines():
    """(metric names of ``bench.py``'s default run in order, keys of its
    ``run_mode`` line, keys of its ``run_sustained`` line), from its AST."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def dumped_keys(fn):
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "dumps" and isinstance(node.args[0], ast.Dict)):
                return node.args[0]
        raise AssertionError(f"no json.dumps in {fn.name}")

    sustained = dumped_keys(fns["run_sustained"])
    names = []
    for stmt in fns["main"].body[-5:]:
        call = stmt.value
        if call.func.id == "run_sustained":
            names.append(sustained.values[0].value)
        else:
            names.append(call.args[0].value)
    return (names, [k.value for k in dumped_keys(fns["run_mode"]).keys],
            [k.value for k in sustained.keys])


def test_bench_twins_print_bench_py_lines():
    """At a tiny configuration on the CPU, ``bench_torch``'s default lines
    carry ``bench.py``'s metric names in its order and its keys in its
    order; ``bench_train_torch`` prints ``tools/bench_train.py``'s lines."""
    names, keys, sustained_keys = _bench_py_lines()
    assert list(bench_torch.DEFAULT_LINES) == names
    assert list(bench_torch.KEYS) == keys and list(bench_torch.SUSTAINED_KEYS) == sustained_keys
    cfg = tcfg.tiny_test_config()
    kw = dict(batch_size=2, points_per_sweep=300, device="cpu", cfg=cfg)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench_torch.run_mode(names[0], "cnn", iters=1, **kw)
        bench_torch.run_mode(names[1], "cnn", voxembed=True, iters=1, **kw)
        bench_torch.run_mode(names[2], "vit", iters=1, **kw)
        bench_torch.run_sustained(batches=2, passes=1, **kw)
        bench_torch.run_mode(names[4], "vit", voxembed=True, iters=1, **kw)
        bench_torch.run_mode("bev_frames_per_sec_per_chip_int8", "vit", int8=True, iters=1, **kw)
        bench_torch.run_mode("bev_frames_per_sec_per_chip_cells", "vit", cells=True, iters=1,
                             **kw)
    lines = [json.loads(s) for s in out.getvalue().splitlines()]
    assert [d["metric"] for d in lines[:5]] == names
    for d in lines:
        want = sustained_keys if d["metric"] == names[3] else keys
        assert list(d) == want
        assert d["unit"] == "frames/s" and d["value"] > 0
        # bench.py's formula rounds the unrounded rate: within half a unit
        # of the fourth decimal of the printed value's (reached exactly when
        # the value is an odd tenth: 1e-12 for the floats' own rounding)
        assert abs(d["vs_baseline"] - d["value"] / 2000.0) <= 5e-5 + 1e-12
    # a rate where the two formulas differ: bench.py gives 0.0865, the rounded
    # value's 173.1 / 2000 would give 0.0866
    with contextlib.redirect_stdout(io.StringIO()):
        d = bench_torch.line("bev_frames_per_sec_per_chip", 173.0999)
    assert d["value"] == 173.1 and d["vs_baseline"] == round(173.0999 / 2000.0, 4) == 0.0865
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r = bench_train_torch.run(batch=2, steps=1, points_per_sweep=300, device="cpu",
                                  cfg=_paired_32(cfg), bwd_fused=False, bwd_kv_chunk=CHUNK)
    text = out.getvalue()
    assert "compile+first step:" in text and "train step:" in text and "ms/batch-2" in text
    assert r["bwd_mode"] == "chunked" and np.isfinite(r["loss"])


def _env_reads(path: Path):
    """(line, enclosing function) of each read of the environment
    (``os.environ``, ``os.getenv``) in a source file."""
    found = []

    def visit(node, fn):
        if isinstance(node, ast.FunctionDef):
            fn = node.name
        name = (node.attr if isinstance(node, ast.Attribute)
                else node.id if isinstance(node, ast.Name) else None)
        if name in ("environ", "getenv"):
            found.append((node.lineno, fn))
        for child in ast.iter_child_nodes(node):
            visit(child, fn)

    visit(ast.parse(path.read_text()), None)
    return found


def test_no_env_var_is_read_below_main():
    """The port and its entry points read the environment only in an entry
    point's ``main()``; ``tools/bench_train_torch.py`` reads the JAX
    package's backward knobs there."""
    files = (sorted((ROOT / "intentbev_torch").rglob("*.py"))
             + [ROOT / "bench_torch.py", ROOT / "chip_smoke.py",
                ROOT / "tools" / "bench_train_torch.py", ROOT / "tools" / "profile_torch_slice.py",
                ROOT / "tools" / "bench_flash_torch.py"])
    bad = {p.relative_to(ROOT).as_posix(): [r for r in _env_reads(p) if r[1] != "main"]
           for p in files}
    assert not any(bad.values()), bad
    assert len(_env_reads(ROOT / "tools" / "bench_train_torch.py")) == 2
