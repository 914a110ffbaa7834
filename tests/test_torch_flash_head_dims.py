"""Attention at every head dim the port's flash kernels take (8 to 128 in
steps of 8) against the JAX package, on the CPU.

On CUDA the kernels of ``csrc/flash_packed.cu`` run a head dim D on the
smallest instance (32, 64, 128) at least D; here the entries take their
plain versions, which this file holds against the JAX kernels:

- the BHTD entries (``intentbev_torch/ops/flash_attention.py``) against
  ``intentbev/ops/flash_attention.py`` in interpret mode at head dims 8,
  16, 48, 96 and 128 (o, lse, dq, dk, dv through the custom VJP), B=1, 2
  heads, T=300 with keys past 283 masked;
- the packed entries against JAX's ``_fwd`` / ``_bwd`` at head dims 16 and
  128 (8 heads of 16 are the fewest that pair into 128 lanes; 1 head of
  128), in each softmax form and each backward form, as
  ``tests/test_torch_flash_fwd.py`` and ``tests/test_torch_flash_split.py``
  run them (module constants patched, excess precision off);
- a rounding point moved at a head dim whose bf16 scale is inexact (48),
  which the bf16 check must see;
- ``tma_geometry``: the instance's box and swizzle at every head dim, and
  the head dims it refuses;
- the dispatch: each head layout of a named width goes where JAX's
  ``flash_attention_packed`` sends it (packed kernels or the BHTD
  fallback), through the model's serving and training entries;
- the reference-checkpoint importer at ``--num_heads 8`` (ViT-B widths) and
  ``--num_heads 3`` (ViT-S widths) against JAX's, and the imported block's
  attention against JAX's on the same weights.

The model at two of these layouts, served and trained against the JAX
model, is ``tests/test_torch_flash_head_dims_slice.py``.

Tolerances (those of ``tests/test_torch_flash_attention.py``): f32, 1e-5 of
the largest value (the same f32 sums in another order); bf16, both sides
round the same f32 values at the same points, so a value differs only where
the summation order tips it to the neighbouring bf16: 1.6e-2 of the largest
value, and at most 2 % of the elements of o, dq, dk and dv may differ; lse
within 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev import import_torch as jimp  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch import import_torch as timp  # noqa: E402
from intentbev_torch.models import vit as tvit  # noqa: E402
from intentbev_torch.ops import flash_attention_packed, flash_attention_packed_bwd  # noqa: E402
from intentbev_torch.ops.flash_attention import (  # noqa: E402
    TmaGeometry, flash_attention, heads_view, instance, tma_geometry)
from intentbev_torch.weights import from_flax  # noqa: E402
from test_torch_flash_attention import _dq_scaled_before_rounding  # noqa: E402
from test_torch_flash_fwd import FORMS, _jax_fwd  # noqa: E402
from test_torch_flash_split import DM, MODES, _inputs, _jax_packed  # noqa: E402
from test_torch_import import _cli_configs, _vit_pth  # noqa: E402

jfa = importlib.import_module("intentbev.ops.flash_attention")
jfp = importlib.import_module("intentbev.ops.flash_packed")
tfa = importlib.import_module("intentbev_torch.ops.flash_attention")
tfp = importlib.import_module("intentbev_torch.ops.flash_packed")

B, H, T, SEQ_LEN = 1, 2, 300, 283  # ragged: keys >= 283 are masked
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LIMITS = {"f32": (1e-5, 1.0), "bf16": (1.6e-2, 2e-2)}  # (of the largest value, share)


def _differ(got, want, name, rel, share):
    """max|got - want| <= rel * max|want|, and at most ``share`` of the
    elements differ at all."""
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{name}: {err} vs {np.abs(want).max()}"
    frac = float((got != want).mean())
    assert frac <= share, f"{name}: {frac:.4f} of the elements differ"
    return frac


@pytest.fixture(scope="module")
def jax_runs():
    """JAX results by their arguments: several tests hold the port against
    one JAX trace (a compile of the interpret-mode kernels each)."""
    return {}


def _bhtd_inputs(d, dtype, seed=0):
    """q, k, v, do f32 [B, H, T, d], exactly representable in ``dtype``."""
    rng = np.random.default_rng(seed)
    return [np.array(jnp.asarray(rng.normal(0, 1, (B, H, T, d)), DTYPES[dtype][0])
                     .astype(jnp.float32)) for _ in range(4)]


def _jax_bhtd(runs, q, k, v, do, dtype):
    """JAX's o, lse and (dq, dk, dv) of ``flash_attention`` (one jitted trace
    in interpret mode, excess precision off), f32."""
    key = (dtype, *(a.tobytes() for a in (q, k, v, do)))
    if key in runs:
        return runs[key]
    jdt, d = DTYPES[dtype][0], q.shape[-1]
    t_pad = jfa._pad_len(T, jfa.BLOCK_Q)

    def prep(x):
        return jnp.pad(x.reshape(B * H, T, d), ((0, 0), (0, t_pad - T), (0, 0)))

    def fwd_bwd(q_, k_, v_, do_):
        def loss(a, b, c):
            o_ = jfa.flash_attention(a, b, c, seq_len=SEQ_LEN)
            return jnp.sum(o_.astype(jnp.float32) * do_.astype(jnp.float32)), o_
        (_, o_), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q_, k_, v_)
        lse_ = jfa._fwd(prep(q_ * jnp.asarray(d ** -0.5, q_.dtype)), prep(k_), prep(v_),
                        SEQ_LEN)[1]
        return o_, lse_, grads

    args = [jnp.asarray(a, jdt) for a in (q, k, v, do)]
    with pltpu.force_tpu_interpret_mode():
        o, lse, grads = jax.jit(fwd_bwd).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    runs[key] = ([np.asarray(a.astype(jnp.float32)) for a in (o, *grads)],
                 np.asarray(lse)[:, :T, 0].reshape(B, H, T))
    return runs[key]


def _port_bhtd(q, k, v, do, dtype):
    """The port's BHTD entry forward and backward (autograd), and its lse."""
    tdt = DTYPES[dtype][1]
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    o = flash_attention(*leaves, SEQ_LEN)
    (o.float() * torch.from_numpy(do).to(tdt).float()).sum().backward()
    lse = tfa.flash_attention_fwd_plain(*(x.detach() for x in leaves), SEQ_LEN)[1]
    return [a.detach().float().numpy() for a in (o, *(x.grad for x in leaves))], lse.numpy()


@pytest.mark.parametrize("d,dtype", [(8, "bf16"), (16, "bf16"), (48, "bf16"), (96, "bf16"),
                                     (128, "bf16"), (48, "f32"), (128, "f32")])
def test_bhtd_entries_match_jax(jax_runs, d, dtype):
    """o, lse, dq, dk and dv at head dims on each instance (8 and 16 on the
    32 one, 48 on 64, 96 and 128 on 128); the padded keys' dk and dv exactly
    0."""
    q, k, v, do = _bhtd_inputs(d, dtype)
    want, want_lse = _jax_bhtd(jax_runs, q, k, v, do, dtype)
    got, lse = _port_bhtd(q, k, v, do, dtype)
    for name, a, w in zip(("o", "dq", "dk", "dv"), got, want):
        _differ(a, w, name, *LIMITS[dtype])
    np.testing.assert_allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert not got[2][:, :, SEQ_LEN:].any() and not got[3][:, :, SEQ_LEN:].any()


@pytest.mark.parametrize("fault", ["f32 scale", "dq scaled before rounding"])
def test_a_moved_rounding_point_is_seen_at_head_dim_48(jax_runs, monkeypatch, fault):
    """At head dim 48 the bf16 scale (0.14453125) is not 48**-0.5: the bf16
    check of dq fails for a plain version with q (and dq) scaled by the f32
    scale, or with dq scaled in f32 before its bf16 rounding."""
    q, k, v, do = _bhtd_inputs(48, "bf16")
    want = _jax_bhtd(jax_runs, q, k, v, do, "bf16")[0]
    if fault == "f32 scale":
        monkeypatch.setattr(tfa, "_scale", lambda d, dtype: torch.tensor(d ** -0.5))
    else:
        monkeypatch.setattr(tfa, "flash_attention_bwd_plain",
                            _dq_scaled_before_rounding(tfa.flash_attention_bwd_plain))
    got = _port_bhtd(q, k, v, do, "bf16")[0]
    with pytest.raises(AssertionError, match="dq"):
        _differ(got[1], want[1], "dq", *LIMITS["bf16"])


PACKED = [(16, "bf16"), (128, "bf16"), (16, "f32"), (128, "f32")]


def _packed_port_bwd(q, k, v, o, lse, do, heads, dtype, mode):
    tdt = DTYPES[dtype][1]
    t = [torch.from_numpy(a).to(tdt) for a in (q, k, v, o, do)]
    fused, chunk = MODES[mode]
    dqkv = flash_attention_packed_bwd(*t[:4], torch.from_numpy(lse), t[4], heads, SEQ_LEN,
                                      fused, chunk).float().numpy()
    return [dqkv[..., j * DM:(j + 1) * DM] for j in range(3)]


@pytest.mark.parametrize("d,dtype", PACKED)
def test_packed_entries_match_jax(jax_runs, d, dtype):
    """Each backward form (fused, split, chunked at 256 keys: JAX pads T to
    768) through the packed entry against JAX's ``_bwd`` in that form, on
    JAX's o and lse; and the safe forward's o and lse against JAX's. f32
    runs the default (fused) form."""
    heads = DM // d
    q, k, v, do = _inputs(np.random.default_rng(d), dtype)
    for mode in MODES if dtype == "bf16" else ("fused",):
        o, lse, want = _jax_packed(q, k, v, do, heads, dtype, mode, jax_runs)
        got = _packed_port_bwd(q, k, v, o, lse, do, heads, dtype, mode)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            _differ(a, w, f"{mode} {name}", *LIMITS[dtype])
        assert not got[1][:, SEQ_LEN:].any() and not got[2][:, SEQ_LEN:].any()
    tdt = DTYPES[dtype][1]
    got_o, got_lse = flash_attention_packed(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                            heads, SEQ_LEN)
    _differ(got_o.float().numpy(), o, "o", *LIMITS[dtype])
    np.testing.assert_allclose(got_lse.numpy(), lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("form", ["chunked", "fixed", "fixed_monolithic"])
def test_packed_forward_forms_match_jax(jax_runs, d, form):
    """The softmax forms other than the safe one (held above), bf16: chunked
    safe at 256 keys, the fixed max (chunked and monolithic in JAX: one
    form here)."""
    heads = DM // d
    q, k, v, _ = _inputs(np.random.default_rng(d), "bf16")
    o, lse = _jax_fwd(jax_runs, q, k, v, heads, "bf16", form)
    (chunk, safe), want_form = FORMS[form]
    assert tfp.fwd_form(T, chunk, not safe) == want_form
    got_o, got_lse = flash_attention_packed(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), heads, SEQ_LEN, chunk, not safe)
    _differ(got_o.float().numpy(), o, "o", *LIMITS["bf16"])
    np.testing.assert_allclose(got_lse.numpy(), lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_tma_geometry_takes_the_instance(d):
    """The map of a head dim D: dims (D, H, T, B) with the true D, boxes of
    the instance's columns (D's instance up to 64, two boxes of 64 at 128),
    swizzled at the box row's bytes; on a packed slice of a [8, 4501,
    3*H*D] qkv output (3 heads) and on a contiguous [2, 3, 1000, D]."""
    inst, chunks, padded = instance(d)
    assert (inst, chunks, padded) == (min(w for w in (32, 64, 128) if w >= d), 1, d)
    cols = min(inst, 64)
    qkv = torch.empty(8, 4501, 9 * d, dtype=torch.bfloat16, device="meta")
    row = 9 * d * 2
    assert tma_geometry(heads_view(qkv[..., 3 * d:6 * d], 3)) == TmaGeometry(
        dims=(d, 3, 4501, 8), strides=(2 * d, row, 4501 * row), box=(cols, 1, 64, 1),
        swizzle=2 * cols)
    x = torch.empty(2, 3, 1000, d, dtype=torch.bfloat16, device="meta")
    assert tma_geometry(x) == ((d, 3, 1000, 2), (2000 * d, 2 * d, 6000 * d),
                               (cols, 1, 64, 1), 2 * cols)


@pytest.mark.parametrize("d", [4, 12, 44, 130, 136, 192, 256])
def test_tma_geometry_refuses_head_dims_without_an_instance(d):
    """Every head dim has a plan now (off a multiple of 8: rows padded to
    the next; above 128: chunks of 128 output columns); what TMA cannot
    take is an unpadded head row off a multiple of 8, which raises naming
    the padded row, and a head dim under 1."""
    inst, chunks, padded = instance(d)
    assert (inst, chunks, padded) == (
        min(w for w in (32, 64, 128) if w >= d) if d <= 128 else 128, -(-d // 128),
        -(-d // 8) * 8)
    x = torch.empty(1, 2, 64, d, dtype=torch.bfloat16, device="meta")
    if d % 8:
        with pytest.raises(ValueError, match=f"head dim {d}: rows of {padded}"):
            tma_geometry(x)
    else:
        assert tma_geometry(x).box == (64, 1, 64, 1)
    assert tma_geometry(x.new_empty(1, 2, 64, padded)[..., :d]).dims == (d, 2, 64, 1)
    with pytest.raises(ValueError, match="head dim 0"):
        instance(0)


# The head layouts of the named widths that the importer's --num_heads (or
# the config's num_heads) reaches: (embed, heads) -> JAX's route
LAYOUTS = {"ViT-B 8x96": (768, 8, "bhtd"), "ViT-B 16x48": (768, 16, "bhtd"),
           "ViT-S 8x48": (384, 8, "bhtd"), "ViT-S 3x128": (384, 3, "packed"),
           "ViT-S 24x16": (384, 24, "packed"), "ViT-Ti 12x16": (192, 12, "bhtd")}


def _jax_route(monkeypatch, dm, heads):
    """Where JAX's ``flash_attention_packed`` (the JAX ViT's attention on
    the TPU) sends [1, 8, dm] q, k, v in ``heads`` heads: its packed kernels
    or the BHTD fallback (both stubbed: only the route is read)."""
    taken = []
    monkeypatch.setattr(jfa, "flash_attention",
                        lambda q, k, v, seq_len=None: taken.append("bhtd") or q)
    monkeypatch.setattr(jfp, "_flash_packed", lambda q, *a: taken.append("packed") or q)
    x = jnp.zeros((1, 8, dm), jnp.float32)
    jfp.flash_attention_packed(x, x, x, heads)
    return taken


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_model_route_follows_jax(monkeypatch, layout):
    """The model's serving entry (``Ops.flash`` of the kernels) and its
    training entry (``train_ops``, forward and backward) reach the BHTD or
    the packed versions, counted, where JAX's dispatch sends the layout."""
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
    if want == "bhtd":
        assert calls == {"flash_attention_fwd_plain": 2, "flash_attention_bwd_plain": 1}
    else:
        assert calls == {"flash_attention_packed_plain": 2, "flash_attention_packed_bwd_plain": 1}
    assert tfp.pairs_heads(dm // heads, heads) is (want == "packed")


@pytest.mark.parametrize("model_name,embed,heads", [("vit_base_patch8_224", 768, 8),
                                                    ("vit_small_patch8_224", 384, 3)])
def test_importer_takes_the_head_count_as_jax_does(tmp_path, model_name, embed, heads):
    """A reference-schema checkpoint at the family's widths (depth 1, numpy
    draws) through both CLIs with ``--num_heads``: the same config.json; the
    port's import equals ``from_flax`` of JAX's bit for bit; and block 0's
    attention on its imported qkv weights (x of [1, 16, embed]) splits the
    heads as JAX's Attention does: the port's model entry against JAX's
    ``flash_attention_packed`` (interpret mode) on JAX's Dense output, f32,
    1e-5 of the largest value."""
    pth = _vit_pth(tmp_path, "ckpt", model_name, embed_dim=embed, depth=1)
    want_cfg, got_cfg = _cli_configs(tmp_path, pth, "--model", "vit", "--num_heads",
                                     str(heads))
    assert got_cfg == want_cfg and got_cfg["vit"]["num_heads"] == heads
    sd = torch.load(pth, weights_only=False)["model_state_dict"]
    layers = tcfg.tiny_test_config().vit.fusion_layers
    jax_vars = jimp.import_vit_state_dict(sd, fusion_layers=layers)
    port_sd = timp.import_vit_state_dict(sd, fusion_layers=layers)
    want = from_flax(jax_vars)
    assert set(port_sd) == set(want)
    for key, val in want.items():
        assert torch.equal(port_sd[key], val), key
    vit_cfg = timp.vit_config_from_state_dict(sd, tcfg.tiny_test_config().vit, num_heads=heads)
    assert (vit_cfg.embed_dim, vit_cfg.num_heads) == (embed, heads)
    x = np.random.default_rng(1).normal(0, 1, (1, 16, embed)).astype(np.float32)
    dense = jax_vars["params"]["backbone"]["vit_lidar"]["block0"]["attn"]["qkv"]
    qkv_j = jnp.asarray(x) @ jnp.asarray(dense["kernel"]) + jnp.asarray(dense["bias"])
    with pltpu.force_tpu_interpret_mode():
        o_j = np.asarray(jfp.flash_attention_packed(*jnp.split(qkv_j, 3, axis=-1), heads))
    w = port_sd["backbone.vit_lidar.blocks.0.attn.qkv.weight"]
    b = port_sd["backbone.vit_lidar.blocks.0.attn.qkv.bias"]
    o_t = tvit.KERNEL_OPS.flash(torch.from_numpy(x) @ w.t() + b, heads, 0, False).numpy()
    _differ(o_t, o_j, "o", *LIMITS["f32"])

