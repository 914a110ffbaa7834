"""The LN+MLP forwards' bf16 rounding points against the JAX package, on the CPU.

JAX's kernels (``intentbev/ops/fused_ln_mlp.py`` ``_fwd_ln_out`` and
``_fwd``, ``intentbev/ops/fused_mlp.py`` ``_fwd``; ``_ln`` and
``_mlp_body``) take LN in f32 and round xn to bf16 before fc1, add b1 and
take the GELU in f32, round h to bf16 before fc2, add b2, the gate and the
residual in f32, round y once and take the next LayerNorm from the f32 y.
The port's plain versions (the CPU path, and the card's oracle for the
kernels of ``csrc/fused_ln_mlp.cu``) are held here against them in bf16:
300 rows from a numpy seed (JAX pads them to its 256-row blocks), JAX in
interpret mode, compiled with ``xla_allow_excess_precision`` off (else
XLA's CPU backend may keep a bf16 value in f32 where a dot reads it).

The reading is the share of y's and yn's elements that differ, limit
``SHARE`` = 1 % (sound readings 0.06-0.23 %: f32 summation order and JAX's
erf, 1.5e-7 from ``erff``, tip a few values to the neighbouring bf16). An
f32 comparison cannot see a moved rounding point; the share can: the
controls, h kept in f32 before fc2 (~30 % of y and of yn) and yn taken from
the bf16-rounded y (~29 % of yn), must exceed the limit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev_torch.ops.fused_ln_mlp import (  # noqa: E402
    fused_ln_mlp_plain, fused_ln_mlp_train_plain, gelu)
from intentbev_torch.ops.fused_mlp import fused_mlp_plain  # noqa: E402
from intentbev_torch.ops.layernorm import layernorm_plain  # noqa: E402

jfl = importlib.import_module("intentbev.ops.fused_ln_mlp")
jfm = importlib.import_module("intentbev.ops.fused_mlp")

N = 300       # rows; JAX pads them to a multiple of its row block
EPS = 1e-6
SHARE = 1e-2  # limit on the share of y's (or yn's) elements that differ


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's outputs by arguments: a compile of an interpret-mode kernel each."""
    return {}


def _inputs(seed, d, gated):
    """bf16 x and residual, bf16 weights in JAX's [in, out] layout, f32 LN
    parameters and biases, f32 per-row gate (or ones)."""
    rng = np.random.default_rng(seed)
    hid = 4 * d

    def bf16(a):  # values a bf16 holds exactly, as f32
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()

    x, res = bf16(rng.normal(0, 1, (N, d))), bf16(rng.normal(0, 1, (N, d)))
    ln = [rng.normal(1 - i % 2, 0.2, d).astype(np.float32) for i in range(4)]
    w1, w2 = bf16(rng.normal(0, d ** -0.5, (d, hid))), bf16(rng.normal(0, hid ** -0.5, (hid, d)))
    b1, b2 = (rng.normal(0, 0.1, n).astype(np.float32) for n in (hid, d))
    gate = (np.where(rng.uniform(size=N) < 0.8, 1 / 0.9, 0.0) if gated
            else np.ones(N)).astype(np.float32)
    return dict(x=x, res=res, ln=ln, w1=w1, b1=b1, w2=w2, b2=b2, gate=gate)


def _jax(runs, entry, gelu_mode, seed, d, gated, monkeypatch):
    """JAX's ``entry`` ("ln_out", "train" or "mlp") outputs, f32 [N, d] each."""
    key = (entry, gelu_mode, seed, d, gated)
    if key in runs:
        return runs[key]
    monkeypatch.setattr(jfm, "_GELU_MODE", gelu_mode)
    a = _inputs(seed, d, gated)
    n_pad = jfl._pad_rows(N)

    def rows(v, dt=jnp.bfloat16):
        return jnp.asarray(np.pad(v.reshape(N, -1), ((0, n_pad - N), (0, 0))), dt)

    x, res, gate = rows(a["x"]), rows(a["res"]), rows(a["gate"], jnp.float32)
    w1, w2 = jnp.asarray(a["w1"], jnp.bfloat16), jnp.asarray(a["w2"], jnp.bfloat16)
    ln = [jnp.asarray(p) for p in a["ln"]]
    b1, b2 = jnp.asarray(a["b1"]), jnp.asarray(a["b2"])
    if entry == "ln_out":
        fn, args = (lambda *t: jfl._fwd_ln_out(*t, EPS)), (x, ln[0], ln[1], w1, b1, w2, b2, gate,
                                                           ln[2], ln[3])
    elif entry == "train":
        fn, args = (lambda *t: jfl._fwd(*t, EPS)), (x, ln[0], ln[1], w1, b1, w2, b2, gate)
    else:
        # a new function each time: jit caches its trace by the function,
        # which would keep the GELU of the first call
        fn, args = (lambda *t: jfm._fwd(*t)), (x, w1, b1, w2, b2, res, gate)
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    out = out if isinstance(out, tuple) else (out,)
    runs[key] = tuple(np.asarray(o.astype(jnp.float32))[:N] for o in out)
    return runs[key]


def _port(entry, gelu_mode, seed, d, gated):
    """The port's plain version of ``entry``, f32 [N, d] each."""
    a = _inputs(seed, d, gated)
    t = {k: torch.from_numpy(v) for k, v in a.items() if k != "ln"}
    ln = [torch.from_numpy(p) for p in a["ln"]]
    x, res = t["x"].bfloat16(), t["res"].bfloat16()
    w1, w2 = t["w1"].t().contiguous().bfloat16(), t["w2"].t().contiguous().bfloat16()
    gate = t["gate"] if gated else None
    if entry == "ln_out":
        out = fused_ln_mlp_plain(x, ln[0], ln[1], w1, t["b1"], w2, t["b2"], ln[2], ln[3], EPS,
                                 gelu_mode)
    elif entry == "train":
        out = (fused_ln_mlp_train_plain(x, ln[0], ln[1], w1, t["b1"], w2, t["b2"], gate, EPS,
                                        gelu_mode),)
    else:
        out = (fused_mlp_plain(x, w1, t["b1"], w2, t["b2"], res, gelu_mode, gate),)
    return tuple(o.float().numpy() for o in out)


def _faulty_ln_out(seed, d, gelu_mode, fault):
    """The serving tail with one fault: ``"h_f32"`` (h not rounded to bf16
    before fc2) or ``"yn_from_bf16_y"`` (LN_next of the rounded y)."""
    a = _inputs(seed, d, False)
    t = {k: torch.from_numpy(v) for k, v in a.items() if k != "ln"}
    ln = [torch.from_numpy(p) for p in a["ln"]]
    xn = layernorm_plain(t["x"], ln[0], ln[1], EPS).bfloat16().float()
    h = gelu(xn @ t["w1"] + t["b1"], gelu_mode)
    if fault != "h_f32":
        h = h.bfloat16().float()
    y = h @ t["w2"] + t["b2"] + t["x"]
    y_lp = y.bfloat16()
    yn = layernorm_plain(y_lp.float() if fault == "yn_from_bf16_y" else y, ln[2], ln[3], EPS)
    return y_lp.float().numpy(), yn.bfloat16().float().numpy()


def _shares(got, want):
    return [float(np.mean(g != w)) for g, w in zip(got, want)]


@pytest.mark.parametrize("d", [384, 192])
@pytest.mark.parametrize("gelu_mode", ["erf", "sigmoid"])
def test_serving_tail_matches_jax(jax_runs, monkeypatch, gelu_mode, d):
    """``fused_ln_mlp_plain`` (y, yn) against ``_fwd_ln_out``."""
    want = _jax(jax_runs, "ln_out", gelu_mode, 0, d, False, monkeypatch)
    got = _port("ln_out", gelu_mode, 0, d, False)
    assert max(_shares(got, want)) <= SHARE, _shares(got, want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=3e-2, rtol=1e-2)


@pytest.mark.parametrize("d", [384, 192])
@pytest.mark.parametrize("gated", [True, False])
def test_training_forward_matches_jax(jax_runs, monkeypatch, gated, d):
    """``fused_ln_mlp_train_plain`` (erf GELU, with and without the
    drop-path gate) against ``_fwd``."""
    want = _jax(jax_runs, "train", "erf", 1, d, gated, monkeypatch)
    got = _port("train", "erf", 1, d, gated)
    assert max(_shares(got, want)) <= SHARE, _shares(got, want)


@pytest.mark.parametrize("gelu_mode,gated", [("erf", True), ("sigmoid", False)])
def test_mlp_without_ln_matches_jax(jax_runs, monkeypatch, gelu_mode, gated):
    """``fused_mlp_plain`` (the gated training forward, the serving tail)
    against ``fused_mlp._fwd``."""
    want = _jax(jax_runs, "mlp", gelu_mode, 2, 384, gated, monkeypatch)
    got = _port("mlp", gelu_mode, 2, 384, gated)
    assert max(_shares(got, want)) <= SHARE, _shares(got, want)


@pytest.mark.parametrize("fault,output", [("h_f32", 0), ("yn_from_bf16_y", 1)])
def test_controls_exceed_the_limit(jax_runs, monkeypatch, fault, output):
    """A moved rounding point reaches the limit: h kept in f32 moves y, yn
    from the bf16 y moves yn."""
    want = _jax(jax_runs, "ln_out", "sigmoid", 0, 384, False, monkeypatch)
    got = _faulty_ln_out(0, 384, "sigmoid", fault)
    assert _shares(got, want)[output] > SHARE, _shares(got, want)
