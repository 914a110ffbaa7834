"""The LN+MLP backwards' bf16 rounding points against the JAX package, on the CPU.

JAX's backward kernels (``intentbev/ops/fused_ln_mlp.py::_bwd_kernel`` and
``intentbev/ops/fused_mlp.py::_bwd_kernel``) take LN in f32 and round xn to
bf16, round dy_eff = dy * gate to bf16 before dh = dy_eff W2, take dg = dh *
GELU'(g) in f32 and round it to bf16 before dxn = dg W1 and dW1 = dg^T xn,
round h = GELU(g) to bf16 before dW2 = h^T dy_eff, sum db1 and db2 from the
f32 dg and dy_eff, and take the LN backward of dx in f32 (rounded once).
The port's plain versions (the CPU path, and the card's oracle for the
kernels of ``csrc/fused_ln_mlp.cu``) are held here against them, reached
through ``jax.vjp`` of the public entries ``fused_ln_mlp`` and
``fused_mlp``: 300 rows from a numpy seed (JAX pads them to its row
blocks), JAX in interpret mode, compiled with ``xla_allow_excess_precision``
off (else XLA's CPU backend may keep a bf16 value in f32 where a dot reads
it). JAX gets f32 weights that bf16 holds exactly, so that its dW come back
in f32 (the custom VJP casts them to the weights' dtype); its products are
then those of bf16 operands.

Readings: the share of dx's elements that differ, limit ``SHARE`` = 1 %
(sound readings 0.06-0.28 %: f32 summation order and JAX's erf, 1.5e-7 from
``erff``, tip a few values to the neighbouring bf16), and the relative L2 of
the f32 dgamma, dbeta, dW1, db1, dW2 and db2, limit ``REL`` = 1e-4 (sound
readings 0-3.8e-5, dW2 at D=192 the largest). A relative L2 of dx cannot
see a moved rounding point; the share can. The controls, each the gated
D=384 backward with one rounding point moved, must exceed a limit: dg kept
in f32 before the dxn product (25.7 % of dx; dgamma and dbeta 1.6e-3), h
kept in f32 in dW2 (dW2 1.7e-3) and db1 summed from the bf16 dg (db1
1.7e-3); each leaves the other outputs sound.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev_torch.ops.fused_ln_mlp import (  # noqa: E402
    fused_ln_mlp_bwd_plain, gelu, gelu_erf_grad)
from intentbev_torch.ops.fused_mlp import fused_mlp_bwd_plain  # noqa: E402

jfl = importlib.import_module("intentbev.ops.fused_ln_mlp")
jfm = importlib.import_module("intentbev.ops.fused_mlp")

N = 300       # rows; JAX pads them to a multiple of its row block
EPS = 1e-6
SHARE = 1e-2  # limit on the share of dx's elements that differ
REL = 1e-4    # limit on the relative L2 of each f32 gradient


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's gradients by arguments: a compile of interpret-mode kernels each."""
    return {}


def _inputs(seed, d, gated):
    """bf16 x and dy, weights bf16 holds in JAX's [in, out] layout, f32 LN
    parameters and biases, f32 per-row gate (or ones)."""
    rng = np.random.default_rng(seed)
    hid = 4 * d

    def bf16(a):  # values a bf16 holds exactly, as f32
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()

    x, dy = bf16(rng.normal(0, 1, (N, d))), bf16(rng.normal(0, 1, (N, d)))
    gamma = rng.normal(1, 0.2, d).astype(np.float32)
    beta = rng.normal(0, 0.2, d).astype(np.float32)
    w1, w2 = bf16(rng.normal(0, d ** -0.5, (d, hid))), bf16(rng.normal(0, hid ** -0.5, (hid, d)))
    b1, b2 = (rng.normal(0, 0.1, n).astype(np.float32) for n in (hid, d))
    gate = (np.where(rng.uniform(size=N) < 0.8, 1 / 0.9, 0.0) if gated
            else np.ones(N)).astype(np.float32)
    return dict(x=x, dy=dy, gamma=gamma, beta=beta, w1=w1, b1=b1, w2=w2, b2=b2, gate=gate)


def _jax(runs, ln, seed, d, gated, monkeypatch):
    """JAX's gradients in the port's order and layout, f32 numpy: (dx,
    dgamma, dbeta, dw1 [hid, d], db1, dw2 [d, hid], db2) with LN, (dx, dw1,
    db1, dw2, db2) without."""
    key = (ln, seed, d, gated)
    if key in runs:
        return runs[key]
    monkeypatch.setattr(jfm, "_GELU_MODE", "erf")
    a = _inputs(seed, d, gated)
    x, dy = jnp.asarray(a["x"], jnp.bfloat16), jnp.asarray(a["dy"], jnp.bfloat16)
    gate = jnp.asarray(a["gate"])
    w1, b1, w2, b2 = (jnp.asarray(a[k]) for k in ("w1", "b1", "w2", "b2"))
    if ln:
        params = (jnp.asarray(a["gamma"]), jnp.asarray(a["beta"]), w1, b1, w2, b2)

        def bwd(x, dy, gate, *p):
            _, vjp = jax.vjp(lambda x, *p: jfl.fused_ln_mlp(x, *p, gate, EPS), x, *p)
            return vjp(dy)
    else:
        params = (w1, b1, w2, b2)

        def bwd(x, dy, gate, *p):  # the residual (x's values, its own input) has dy
            _, vjp = jax.vjp(lambda x, r, *p: jfm.fused_mlp(x, *p, r, gate), x, x, *p)
            return (vjp(dy)[0],) + vjp(dy)[2:]
    args = (x, dy, gate, *params)
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(bwd).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    out = [np.asarray(o.astype(jnp.float32)) for o in out]
    if ln:  # (dx, dgamma, dbeta, dw1, db1, dw2, db2)
        out = [out[0], out[1], out[2], out[3].T, out[4], out[5].T, out[6]]
    else:  # (dx, dw1, db1, dw2, db2)
        out = [out[0], out[1].T, out[2], out[3].T, out[4]]
    runs[key] = out
    return out


def _port_args(seed, d, gated):
    a = _inputs(seed, d, gated)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return (t["x"].bfloat16(), t["gamma"], t["beta"], t["w1"].t().contiguous().bfloat16(),
            t["b1"], t["w2"].t().contiguous().bfloat16(), t["gate"] if gated else None,
            t["dy"].bfloat16())


def _port(ln, seed, d, gated):
    x, gamma, beta, w1, b1, w2, gate, dy = _port_args(seed, d, gated)
    out = (fused_ln_mlp_bwd_plain(x, gamma, beta, w1, b1, w2, gate, dy, EPS) if ln
           else fused_mlp_bwd_plain(x, w1, b1, w2, gate, dy))
    return [o.float().numpy() for o in out]


def _faulty(seed, d, fault):
    """The LN backward (gated) with one rounding point moved: ``"dg_f32"``
    (dxn from the f32 dg), ``"h_f32"`` (dW2 from the f32 h) or
    ``"db1_bf16"`` (db1 summed from the bf16 dg); in the port's order."""
    x, gamma, beta, w1, b1, w2, gate, dy = _port_args(seed, d, True)
    xf, dyf, w1f, w2f = x.float(), dy.float(), w1.float(), w2.float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + EPS)
    xhat = xc * inv
    xn = (xhat * gamma + beta).bfloat16().float()
    g = xn @ w1f.t() + b1
    dye = dyf * gate[:, None]
    dye_lp = dye.bfloat16().float()
    dg = (dye_lp @ w2f) * gelu_erf_grad(g)
    dg_lp = dg.bfloat16().float()
    dxn = (dg if fault == "dg_f32" else dg_lp) @ w1f
    dyg = dxn * gamma
    dx = inv * (dyg - dyg.mean(-1, keepdim=True) - xhat * (dyg * xhat).mean(-1, keepdim=True))
    h = gelu(g, "erf")
    h = h if fault == "h_f32" else h.bfloat16().float()
    out = (dx + dyf, (dxn * xhat).sum(0), dxn.sum(0), dg_lp.t() @ xn,
           (dg_lp if fault == "db1_bf16" else dg).sum(0), dye_lp.t() @ h, dye.sum(0))
    return [o.bfloat16().float().numpy() if i == 0 else o.numpy() for i, o in enumerate(out)]


def _readings(got, want):
    """dx's share of differing elements, then each f32 gradient's relative L2."""
    return [float(np.mean(got[0] != want[0]))] + [
        float(np.linalg.norm(g - w) / np.linalg.norm(w)) for g, w in zip(got[1:], want[1:])]


@pytest.mark.parametrize("d,gated", [(384, True), (384, False), (192, True), (192, False)])
def test_ln_mlp_backward_matches_jax(jax_runs, monkeypatch, d, gated):
    """``fused_ln_mlp_bwd_plain`` against ``_bwd_kernel`` through the VJP of
    ``fused_ln_mlp``."""
    r = _readings(_port(True, 0, d, gated), _jax(jax_runs, True, 0, d, gated, monkeypatch))
    assert r[0] <= SHARE and max(r[1:]) <= REL, r


@pytest.mark.parametrize("d", [384, 192])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_backward_matches_jax(jax_runs, monkeypatch, gated, d):
    """``fused_mlp_bwd_plain`` against ``fused_mlp._bwd_kernel`` through the
    VJP of ``fused_mlp``, at ViT-S's and ViT-Ti's widths."""
    r = _readings(_port(False, 1, d, gated), _jax(jax_runs, False, 1, d, gated, monkeypatch))
    assert r[0] <= SHARE and max(r[1:]) <= REL, r


@pytest.mark.parametrize("fault,output", [("dg_f32", 0), ("h_f32", 5), ("db1_bf16", 4)])
def test_controls_exceed_the_limits(jax_runs, monkeypatch, fault, output):
    """A moved rounding point reaches its limit: dg kept in f32 before dxn
    moves dx, h kept in f32 moves dW2, db1 from the bf16 dg moves db1; the
    other outputs of each control stay sound."""
    want = _jax(jax_runs, True, 0, 384, True, monkeypatch)
    r = _readings(_faulty(0, 384, fault), want)
    limits = [SHARE] + [REL] * 6
    assert r[output] > limits[output], r
    assert all(v <= lim for i, (v, lim) in enumerate(zip(r, limits))
               if i != output and not (fault == "dg_f32" and i in (1, 2))), r
