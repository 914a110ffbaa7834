"""The packed attention's forward in JAX's three softmax forms against the
JAX package, on the CPU; the model's choice of form.

JAX's ``_fwd`` (``intentbev/ops/flash_packed.py:303-306``) rounds P = exp(s -
m) to bf16 against a different m in each form: the monolithic safe kernel
(``_fwd_kernel``, safe) against the row's true max, the fixed-max form
(either kernel with safe=False; ``bench.py``'s serving configuration)
against m = 0, the chunked safe kernel (``_fwd_kernel_chunked``, safe)
against a running max updated once per ``kv_chunk`` keys. The port's plain
forward takes the form from ``kv_chunk`` / ``unsafe_softmax``
(``ops.flash_packed.fwd_form``) and is held here against ``_fwd`` in that
form, in interpret mode, compiled with ``xla_allow_excess_precision`` off
(as ``test_torch_flash_split.py`` runs it): B=1, T=300 with keys past 283
masked, JAX padding T to 768, so chunk 256 takes the chunked kernel there.

Tolerances, those of ``test_torch_flash_split.py``: f32, 1e-5 of the
largest value; bf16, 1.6e-2 of the largest value and at most 0.3 % of o's
elements differing (sound readings <= 0.12 %); lse within 1e-5. The
controls show the share check sees a moved rounding point: the safe plain
forward against JAX's fixed max (~48 % of o differs), a running max over
64-key tiles (the port's kernel before it took JAX's forms) against JAX's
monolithic safe form (~27 %), and the monolithic safe plain forward against
JAX's chunked form (~4 %).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.models import IntentNetViT, init_params  # noqa: E402
from test_torch_flash_split import (B, BF16_REL, BF16_SHARE, DM, DTYPES, SEQ_LEN, T,  # noqa: E402
                                    _differ, _inputs, _limits)

jfp = importlib.import_module("intentbev.ops.flash_packed")
tfp = importlib.import_module("intentbev_torch.ops.flash_packed")

CHUNK = 256  # divides JAX's padded 768 rows
# name: (JAX's kv_chunk, safe), and the port's form for the same arguments
FORMS = {"safe": ((0, True), "safe"), "chunked": ((CHUNK, True), "chunked"),
         "fixed": ((CHUNK, False), "fixed"), "fixed_monolithic": ((0, False), "fixed")}


@pytest.fixture(scope="module")
def jax_fwd_runs():
    """JAX's (o, lse) by arguments: the tests hold several port forwards
    against one JAX trace (a compile of the interpret-mode kernel each)."""
    return {}


def _jax_fwd(runs, q, k, v, heads, dtype, form):
    """JAX's o [B, T, DM] and lse [B, H, T] of ``_fwd`` in ``form``, f32."""
    key = (heads, dtype, form, *(a.tobytes() for a in (q, k, v)))
    if key in runs:
        return runs[key]
    jdt = DTYPES[dtype][0]
    dh = DM // heads
    t_pad = jfp._pad_len(T, 768)
    (chunk, safe), _ = FORMS[form]

    def fwd(q3, k3, v3):
        return jfp._fwd(q3, k3, v3, heads, 1.0 / dh ** 0.5, SEQ_LEN, chunk, safe)

    args = [jnp.pad(jnp.asarray(a, jdt), ((0, 0), (0, t_pad - T), (0, 0))) for a in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        o, lse = jax.jit(fwd).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    runs[key] = (np.asarray(o.astype(jnp.float32))[:, :T], np.asarray(lse)[:, :, :T, 0])
    return runs[key]


def _port_fwd(q, k, v, heads, dtype, kv_chunk, unsafe_softmax):
    tdt = DTYPES[dtype][1]
    o, lse = tfp.flash_attention_packed_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), heads, SEQ_LEN, kv_chunk,
        unsafe_softmax)
    return o.float().numpy(), lse.numpy()


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dh", [64, 32])
def test_forward_form_matches_jax(rng, jax_fwd_runs, dh, dtype, form):
    """o and lse of the plain forward in each form against JAX's ``_fwd``
    in that form (kv_chunk, safe), at head dims 64 and 32."""
    heads = DM // dh
    q, k, v, _ = _inputs(rng, dtype)
    o, lse = _jax_fwd(jax_fwd_runs, q, k, v, heads, dtype, form)
    (chunk, safe), want_form = FORMS[form]
    assert tfp.fwd_form(T, chunk, not safe) == want_form
    got_o, got_lse = _port_fwd(q, k, v, heads, dtype, chunk, not safe)
    _differ(got_o, o, "o", *_limits(dtype))
    np.testing.assert_allclose(got_lse, lse, rtol=1e-5, atol=1e-5)


def _tile_running_max(q, k, v, heads, tile=64):
    """The control's fault: P rounded against a running max over ``tile``-key
    tiles (the chunked recurrence per tile), bf16."""
    dh = DM // heads
    sb = tfp.scales(dh, torch.bfloat16)[0]
    qt, kt, vt = (torch.from_numpy(a).bfloat16()[0].reshape(T, heads, dh).transpose(0, 1)
                  for a in (q, k, v))
    s = torch.matmul((qt.float() * sb).bfloat16().float(), kt.float().transpose(-1, -2))
    s[..., SEQ_LEN:] = float("-inf")
    o, _ = tfp.softmax_pv(s, vt.float(), torch.bfloat16, "chunked", tile)
    return o.transpose(0, 1).reshape(B, T, DM).bfloat16().float().numpy()


CONTROLS = {  # name: (JAX's form, the port's output with the fault)
    "safe against the fixed max": (
        "fixed", lambda q, k, v, heads: _port_fwd(q, k, v, heads, "bf16", 0, False)[0]),
    "a running max over 64-key tiles against the safe form": (
        "safe", lambda q, k, v, heads: _tile_running_max(q, k, v, heads)),
    "monolithic safe against the chunked form": (
        "chunked", lambda q, k, v, heads: _port_fwd(q, k, v, heads, "bf16", 0, False)[0]),
}


@pytest.mark.parametrize("control", list(CONTROLS))
@pytest.mark.parametrize("dh", [64, 32])
def test_rounding_faults_are_seen(rng, jax_fwd_runs, dh, control):
    """bf16: the share check of o fails for a plain forward that rounds P
    against another form's max."""
    heads = DM // dh
    jax_form, port = CONTROLS[control]
    q, k, v, _ = _inputs(rng, "bf16")
    o = _jax_fwd(jax_fwd_runs, q, k, v, heads, "bf16", jax_form)[0]
    with pytest.raises(AssertionError, match="of the elements differ"):
        _differ(port(q, k, v, heads), o, "o", BF16_REL, BF16_SHARE)


def test_fwd_form_follows_jax():
    """The form JAX's ``_fwd`` takes: fixed under ``unsafe_softmax`` whatever
    the chunk, chunked where the chunk divides the length padded to 768
    rows, else monolithic safe."""
    assert tfp.fwd_form(4501, 1152) == "chunked"  # 4608 rows
    assert tfp.fwd_form(4501, 1000) == "safe"
    assert tfp.fwd_form(4501, 1152, True) == "fixed"
    assert tfp.fwd_form(4501, 0, True) == "fixed"
    assert tfp.fwd_form(300, CHUNK) == "chunked"  # 768 rows
    assert tfp.fwd_form(tfp.pad_len(97, tfp.MODEL_PAD_ROWS), 512) == "safe"
    assert tfp.fwd_form(4501) == "safe"


@pytest.mark.parametrize("dh", [64, 32])
def test_fixed_max_does_not_depend_on_the_chunk(rng, dh):
    """With m = 0, P does not depend on the tiling: every chunk gives the
    same bits (JAX's fixed-max forms agree in every element too)."""
    q, k, v, _ = _inputs(rng, "bf16")
    ref = _port_fwd(q, k, v, DM // dh, "bf16", 0, True)
    for chunk in (CHUNK, 384, 1000):
        got = _port_fwd(q, k, v, DM // dh, "bf16", chunk, True)
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])


def _model_inputs(cfg, seed=0):
    g = cfg.grid
    r = np.random.default_rng(seed)
    bev = torch.from_numpy(
        r.uniform(0, 1, (2, g.height_px, g.width_px, g.lidar_total_channels)).astype(np.float32))
    mp = torch.from_numpy(
        (r.uniform(size=(2, g.height_px, g.width_px, g.map_channels)) < 0.05).astype(np.float32))
    return bev, mp


def _vit(embed_dim, num_heads, **switches):
    base = tcfg.tiny_test_config()
    cfg = dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, use_flash_attention=True, embed_dim=embed_dim, num_heads=num_heads,
        drop_path_rate=0.0, **switches))
    model = IntentNetViT(cfg.vit, cfg.heads)
    model.load_state_dict(init_params(cfg, seed=0))
    return cfg, model


MODEL_FORMS = {"safe": {}, "fixed": dict(unsafe_softmax=True, fwd_kv_chunk=CHUNK),
               "chunked": dict(fwd_kv_chunk=CHUNK)}


@pytest.mark.parametrize("form", list(MODEL_FORMS))
def test_model_runs_the_form_of_its_config(form, monkeypatch):
    """The ViT with 4 heads of 32 (they pair: the packed entries) runs the
    forward form its ``fwd_kv_chunk`` / ``unsafe_softmax`` name in every
    attention (2 streams x 2 blocks), serving and training, over the 768
    rows JAX pads its 97 tokens to; the backward reads no form."""
    taken = []
    fwd_form = tfp.fwd_form
    monkeypatch.setattr(tfp, "fwd_form", lambda *a: taken.append(fwd_form(*a)) or taken[-1])
    cfg, model = _vit(128, 4, **MODEL_FORMS[form])
    bev, mp = _model_inputs(cfg)
    with torch.no_grad():
        model.eval()(bev, mp)
    assert taken == [form] * 4
    taken.clear()
    out = model.train()(bev, mp, torch.Generator().manual_seed(0))
    sum(o.sum() for o in out).backward()
    assert taken == [form] * 4


def test_bhtd_path_ignores_the_form(monkeypatch):
    """ViT-Ti's 3 heads of 64 do not pair: the BHTD entries take the true row
    max whatever the switches, as JAX's fallback does; the same bits served
    and trained, and no form is asked for."""
    taken = []
    fwd_form = tfp.fwd_form
    monkeypatch.setattr(tfp, "fwd_form", lambda *a: taken.append(fwd_form(*a)) or taken[-1])
    outs = []
    for switches in ({}, dict(unsafe_softmax=True, fwd_kv_chunk=CHUNK)):
        cfg, model = _vit(192, 3, **switches)
        bev, mp = _model_inputs(cfg)
        with torch.no_grad():
            served = model.eval()(bev, mp)
        trained = model.train()(bev, mp, torch.Generator().manual_seed(0))
        outs.append([t.detach() for t in (*served, *trained)])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert taken == []


def test_unsafe_softmax_moves_the_paired_model():
    """Control of the BHTD test: where the heads pair, the fixed max moves
    the served logits (P rounds against another max)."""
    outs = []
    for switches in ({}, dict(unsafe_softmax=True)):
        cfg, model = _vit(128, 4, **switches)
        bev, mp = _model_inputs(cfg)
        with torch.no_grad():
            outs.append(model.eval()(bev, mp))
    assert not all(torch.equal(a, b) for a, b in zip(*outs))
