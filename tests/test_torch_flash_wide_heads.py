"""Attention at every head dim JAX's attention takes, against the JAX package
on the CPU: head dims above 128 and head dims off a multiple of 8.

On CUDA the kernels of ``csrc/flash_packed.cu`` run a head dim above 128 as
chunks of 128 output columns (every chunk reducing the scores over the
whole head), and a head dim off a multiple of 8 over rows padded to the
next multiple of 8 (``ops/flash_attention.py::instance``); here the entries
take their plain versions, which this file holds against the JAX kernels:

- the BHTD entries (``intentbev_torch/ops/flash_attention.py``) against
  ``intentbev/ops/flash_attention.py`` in interpret mode at head dims 136,
  192, 256, 384 and 768 (two to six chunks) and 1, 3, 6, 12 and 20 (rows
  padded to 8, 8, 8, 16 and 24), bf16, and f32 at 256 and 12: o, lse, dq,
  dk and dv through the custom VJP, B=1, 2 heads, T=300 with keys past 283
  masked;
- the packed entries at head dims 1, 2 and 4 (128, 64 and 32 heads in 128
  columns: the heads pair) against JAX's ``_fwd`` and ``_bwd``, as
  ``tests/test_torch_flash_fwd.py`` and ``tests/test_torch_flash_split.py``
  run them: every softmax form and backward form at 4, the safe and fixed
  forwards with the fused backward at 1 and 2, and the split one at 2
  (``PACKED_FORMS``);
- two faults the checks must see: a rounding point moved at a head dim
  whose bf16 scale is inexact (192), and the scores reduced over one chunk
  of 128 columns only (what a chunk that skipped the others' columns would
  give);
- the pure functions: ``instance`` (the instance, the chunks and the padded
  row) and ``tma_geometry`` on the padded views for every head dim from 1 to
  1024, and its refusal of an unpadded view off a multiple of 8;
- the dispatch: every head layout of ViT-B's, ViT-S's and ViT-Ti's widths
  that ``--num_heads`` reaches goes where JAX's ``flash_attention_packed``
  sends it, through the model's serving and training entries, counted.

Tolerances (those of ``tests/test_torch_flash_attention.py``): f32, 1e-5 of
the largest value; bf16, 1.6e-2 of the largest value and at most 2 % of the
elements of o, dq, dk and dv differing; lse within 1e-5. The model at two of
these layouts, and the importer, are
``tests/test_torch_flash_wide_heads_slice.py``.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from intentbev_torch.models import vit as tvit  # noqa: E402
from intentbev_torch.ops import flash_attention_packed, flash_attention_packed_bwd  # noqa: E402
from intentbev_torch.ops.flash_attention import (  # noqa: E402
    CHUNK_COLS, HEAD_DIMS, ROW_STEP, Plan, heads_view, instance, padded_rows, tma_geometry)
from test_torch_flash_fwd import FORMS, _jax_fwd  # noqa: E402
from test_torch_flash_head_dims import (  # noqa: E402
    LIMITS, _bhtd_inputs, _differ, _jax_bhtd, _jax_route, _port_bhtd)
from test_torch_flash_split import DM, MODES, _inputs, _jax_packed  # noqa: E402

tfa = importlib.import_module("intentbev_torch.ops.flash_attention")
tfp = importlib.import_module("intentbev_torch.ops.flash_packed")

SEQ_LEN = 283  # that of the helpers' inputs: keys >= 283 are masked
WIDE = [136, 192, 256, 384, 768]  # two to six chunks of 128 output columns
ODD = [1, 3, 6, 12, 20]  # rows padded to 8, 8, 8, 16, 24 columns
PACKED_ODD = [1, 2, 4]  # off a multiple of 8 with heads that pair into 128 lanes


@pytest.fixture(scope="module")
def jax_runs():
    """JAX results by their arguments (a compile of the interpret-mode
    kernels each)."""
    return {}


@pytest.mark.parametrize("d,dtype", [(d, "bf16") for d in WIDE + ODD]
                         + [(256, "f32"), (12, "f32")])
def test_bhtd_entries_match_jax(jax_runs, d, dtype):
    """o, lse, dq, dk and dv at the chunked and the padded head dims; the
    masked keys' dk and dv exactly 0."""
    q, k, v, do = _bhtd_inputs(d, dtype)
    want, want_lse = _jax_bhtd(jax_runs, q, k, v, do, dtype)
    got, lse = _port_bhtd(q, k, v, do, dtype)
    for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        _differ(a, w, f"{d} {name}", *LIMITS[dtype])
    np.testing.assert_allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert not got[2][:, :, SEQ_LEN:].any() and not got[3][:, :, SEQ_LEN:].any()


def _one_chunk(fn):
    """fn with its q and k cut to their first chunk of 128 columns (the rest
    zero): the scores a chunk that skipped the others' columns would give."""
    def faulty(q, k, *args, **kw):
        cut = [torch.cat([x[..., :CHUNK_COLS], torch.zeros_like(x[..., CHUNK_COLS:])], -1)
               for x in (q, k)]
        return fn(*cut, *args, **kw)
    return faulty


@pytest.mark.parametrize("fault", ["f32 scale", "S over one chunk"])
def test_faults_are_seen_at_head_dim_192(jax_runs, monkeypatch, fault):
    """At 192 (two chunks; the bf16 scale 0.072265625 is not 192**-0.5) the
    bf16 check of dq fails for a plain version with q (and dq) scaled by the
    f32 scale, and the check of o for one whose scores cover one chunk."""
    q, k, v, do = _bhtd_inputs(192, "bf16")
    want = _jax_bhtd(jax_runs, q, k, v, do, "bf16")[0]
    if fault == "f32 scale":
        monkeypatch.setattr(tfa, "_scale", lambda d, dtype: torch.tensor(d ** -0.5))
        got = _port_bhtd(q, k, v, do, "bf16")[0]
        with pytest.raises(AssertionError, match="dq"):
            _differ(got[1], want[1], "dq", *LIMITS["bf16"])
    else:
        monkeypatch.setattr(tfa, "flash_attention_fwd_plain",
                            _one_chunk(tfa.flash_attention_fwd_plain))
        got = _port_bhtd(q, k, v, do, "bf16")[0]
        with pytest.raises(AssertionError, match="o"):
            _differ(got[0], want[0], "o", *LIMITS["bf16"])


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


# The forms held at each packed head dim. JAX's packed kernels take a lane
# block's heads one at a time, so their interpret-mode compile grows with
# the heads in 128 lanes (at 128 heads of 1: 27 s for the fused backward,
# 38 s for a chunked forward): every form at 4 (32 heads; the fixed max by
# JAX's monolithic kernel: the port's fixed form is one for JAX's two); at 2
# and 1 the fused backward (with the safe forward it runs on) and the fixed
# max, and at 2 the split backward.
PACKED_FORMS = {4: (("fused", "split", "chunked"), ("chunked", "fixed_monolithic")),
                2: (("fused", "split"), ("fixed_monolithic",)),
                1: (("fused",), ("fixed_monolithic",))}


@pytest.mark.parametrize("d", PACKED_ODD)
def test_packed_entries_match_jax(jax_runs, d):
    """The packed entries at 128 / d heads of d over [1, 300, 128], bf16:
    backward forms (fused, split, chunked at 256 keys) against JAX's
    ``_bwd`` in that form on JAX's o and lse, the safe forward against the o
    and lse JAX's backward ran on, and softmax forms (chunked safe at 256
    keys, the fixed max) against JAX's ``_fwd`` (:data:`PACKED_FORMS`)."""
    heads = DM // d
    assert tfp.pairs_heads(d, heads) and instance(d).padded == ROW_STEP
    q, k, v, do = _inputs(np.random.default_rng(d), "bf16")
    bwd_forms, fwd_forms = PACKED_FORMS[d]
    for mode in bwd_forms:
        fused, chunk = MODES[mode]
        o, lse, want = _jax_packed(q, k, v, do, heads, "bf16", mode, jax_runs)
        dqkv = flash_attention_packed_bwd(*(_bf16(a) for a in (q, k, v, o)),
                                          torch.from_numpy(lse), _bf16(do), heads, SEQ_LEN,
                                          fused, chunk).float().numpy()
        got = [dqkv[..., j * DM:(j + 1) * DM] for j in range(3)]
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            _differ(a, w, f"{d} {mode} {name}", *LIMITS["bf16"])
        assert not got[1][:, SEQ_LEN:].any() and not got[2][:, SEQ_LEN:].any()
    got_o, got_lse = flash_attention_packed(*(_bf16(a) for a in (q, k, v)), heads, SEQ_LEN)
    _differ(got_o.float().numpy(), o, f"{d} safe o", *LIMITS["bf16"])
    np.testing.assert_allclose(got_lse.numpy(), lse, rtol=1e-5, atol=1e-5)
    for form in fwd_forms:
        (chunk, safe), want_form = FORMS[form]
        o, lse = _jax_fwd(jax_runs, q, k, v, heads, "bf16", form)
        assert tfp.fwd_form(300, chunk, not safe) == want_form
        got_o, got_lse = flash_attention_packed(*(_bf16(a) for a in (q, k, v)), heads, SEQ_LEN,
                                                chunk, not safe)
        _differ(got_o.float().numpy(), o, f"{d} {form} o", *LIMITS["bf16"])
        np.testing.assert_allclose(got_lse.numpy(), lse, rtol=1e-5, atol=1e-5)


def _plan(d):
    """The plan worked out by hand."""
    inst = min([w for w in HEAD_DIMS if w >= d] or [CHUNK_COLS])
    return Plan(inst, (d + 127) // 128, (d + 7) // 8 * 8)


@pytest.mark.parametrize("lo,hi", [(1, 129), (129, 1025)])
def test_plan_and_padded_geometry_at_every_head_dim(lo, hi):
    """For every head dim from 1 to 1024: the plan (instance, chunks, padded
    row); the map of the padded view of a [2, 3, 100, padded] buffer (the
    true d innermost, 16-byte strides of the padded row, boxes of the
    instance's columns, 64 above 32); and of the head views of a qkv
    output's q slice where d is a multiple of 8."""
    for d in range(lo, hi):
        plan = instance(d)
        assert plan == _plan(d), d
        cols = min(plan.inst, 64)
        view = torch.empty(2, 3, 100, plan.padded, dtype=torch.bfloat16, device="meta")[..., :d]
        pd = plan.padded
        assert tma_geometry(view) == ((d, 3, 100, 2), (200 * pd, 2 * pd, 600 * pd),
                                      (cols, 1, 64, 1), 2 * cols), d
        if d % 8 == 0:
            qkv = torch.empty(1, 100, 3 * 2 * d, dtype=torch.bfloat16, device="meta")
            assert tma_geometry(heads_view(qkv[..., :2 * d], 2)) == (
                (d, 2, 100, 1), (2 * d, 12 * d, 1200 * d), (cols, 1, 64, 1), 2 * cols), d


@pytest.mark.parametrize("d", [1, 3, 6, 12, 20, 60, 97, 130])
def test_unpadded_odd_views_are_refused(d):
    """A view of unpadded heads off a multiple of 8 (a head stride of 2d
    bytes) raises, naming the padded row it needs; its padded copy is taken,
    holds the same values and zeros past d."""
    x = torch.randn(1, 5, 3 * d)
    view = heads_view(x[..., :3 * d].bfloat16(), 3)
    with pytest.raises(ValueError, match=f"head dim {d}: rows of {instance(d).padded}"):
        tma_geometry(view)
    padded = padded_rows(view, instance(d).padded)
    assert tma_geometry(padded).dims == (d, 3, 5, 1)
    assert torch.equal(padded, view)
    assert not padded.as_strided((1, 3, 5, instance(d).padded), padded.stride())[..., d:].any()
    with pytest.raises(ValueError, match="head dim 0"):
        instance(0)


# Every head layout of the named widths that --num_heads reaches with a head
# dim above 128 or off a multiple of 8: (embed, heads) -> JAX's route
LAYOUTS = {
    "ViT-B 4x192": (768, 4, "bhtd"), "ViT-B 3x256": (768, 3, "bhtd"),
    "ViT-B 2x384": (768, 2, "bhtd"), "ViT-B 1x768": (768, 1, "bhtd"),
    "ViT-B 768x1": (768, 768, "packed"), "ViT-B 384x2": (768, 384, "packed"),
    "ViT-B 192x4": (768, 192, "packed"), "ViT-B 256x3": (768, 256, "bhtd"),
    "ViT-B 128x6": (768, 128, "bhtd"), "ViT-B 64x12": (768, 64, "bhtd"),
    "ViT-S 2x192": (384, 2, "bhtd"), "ViT-S 1x384": (384, 1, "bhtd"),
    "ViT-S 384x1": (384, 384, "packed"), "ViT-S 192x2": (384, 192, "packed"),
    "ViT-S 96x4": (384, 96, "packed"), "ViT-S 128x3": (384, 128, "bhtd"),
    "ViT-S 64x6": (384, 64, "bhtd"), "ViT-S 32x12": (384, 32, "bhtd"),
    "ViT-Ti 1x192": (192, 1, "bhtd"), "ViT-Ti 192x1": (192, 192, "bhtd"),
    "ViT-Ti 96x2": (192, 96, "bhtd"), "ViT-Ti 64x3": (192, 64, "bhtd"),
    "ViT-Ti 48x4": (192, 48, "bhtd"), "ViT-Ti 32x6": (192, 32, "bhtd"),
    "ViT-Ti 16x12": (192, 16, "bhtd")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_model_route_follows_jax(monkeypatch, layout):
    """The model's serving entry (``Ops.flash`` of the kernels) and its
    training entry (``train_ops``, forward and backward) reach the BHTD or
    the packed versions, counted, where JAX's dispatch sends the layout;
    the serving and training outputs agree bit for bit."""
    dm, heads, want = LAYOUTS[layout]
    assert _jax_route(monkeypatch, dm, heads) == [want]
    calls = {}
    for mod, name in ((tfa, "flash_attention_fwd_plain"), (tfa, "flash_attention_bwd_plain"),
                      (tfp, "flash_attention_packed_plain"),
                      (tfp, "flash_attention_packed_bwd_plain")):
        def wrap(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.normal(0, 1, (1, 8, 3 * dm)).astype(np.float32))
    o = tvit.KERNEL_OPS.flash(qkv, heads, 0, False)
    qkv.requires_grad_(True)
    o_t = tvit.train_ops(False).flash(qkv, heads, 0, False)
    o_t.sum().backward()
    torch.testing.assert_close(o_t.detach(), o, rtol=0, atol=0)
    assert torch.isfinite(qkv.grad).all()
    if want == "bhtd":
        assert calls == {"flash_attention_fwd_plain": 2, "flash_attention_bwd_plain": 1}
    else:
        assert calls == {"flash_attention_packed_plain": 2, "flash_attention_packed_bwd_plain": 1}
    assert tfp.pairs_heads(dm // heads, heads) is (want == "packed")
