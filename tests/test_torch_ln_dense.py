"""The LN+dense pair's bf16 rounding points against the JAX package, on the CPU.

JAX's kernels (``intentbev/ops/fused_ln_dense.py`` ``_fwd_kernel`` and
``_bwd_kernel``) take LN in f32 and round xn to bf16 before the product; the
forward adds the bias and takes the GELU in f32 and rounds y once; the
backward takes g = xn W + b in f32 (GELU only), dg = dy * GELU'(g) in f32 (or
dy), rounds dg to bf16 before dxn = dg W^T and dW = xn^T dg, sums db from the
f32 dg, and takes the LN backward of dx in f32 (rounded once). The port's
plain versions (the CPU path, and the card's oracle for the kernels of
``csrc/fused_ln_dense.cu``) are held here against them in bf16, at D = 384
and 192: the qkv projection (Dout = 3D, no GELU) and the adapter (Dout = 192,
the erf GELU, and the serving sigmoid GELU forward), 300 rows from a numpy
seed (JAX pads them to its 256-row blocks), JAX in interpret mode, compiled
with ``xla_allow_excess_precision`` off (else XLA's CPU backend may keep a
bf16 value in f32 where a dot reads it), through ``jax.vjp`` of the public
``fused_ln_dense`` for the backward. JAX gets f32 weights that bf16 holds
exactly, so that its dW comes back in f32 (the custom VJP casts it to the
weights' dtype); its products are then those of bf16 operands. JAX's GELU is
the module global ``fused_mlp._GELU_MODE`` (monkeypatched); jit caches a
trace by the function, so each JAX call gets a new lambda.

Readings: the share of y's and of dx's elements that differ, limit ``SHARE``
= 1 % (sound readings 0-0.095 % of y, 0.012-0.075 % of dx: f32 summation
order and JAX's erf tip a few values to the neighbouring bf16), and the
relative L2 of the f32 dgamma, dbeta, dW and db, limit ``REL`` = 1e-4 (sound
readings 1.1e-9-3.1e-5, dW the largest). A relative L2 cannot see a moved
rounding point; the share can. The controls, each one rounding point moved
at D = 384, must exceed a limit: xn kept in f32 before the product (42 % of
y without GELU, 41 % with the erf GELU), dg kept in f32 before dxn (the
GELU case: 43 % of dx; dgamma and dbeta 1.5e-3 and 1.7e-3) and db summed
from the bf16 dg (db 1.7e-3); each leaves the other outputs sound.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev_torch.ops.fused_ln_dense import (  # noqa: E402
    fused_ln_dense_bwd_plain, fused_ln_dense_plain)
from intentbev_torch.ops.fused_ln_mlp import gelu, gelu_erf_grad  # noqa: E402

jfd = importlib.import_module("intentbev.ops.fused_ln_dense")
jfm = importlib.import_module("intentbev.ops.fused_mlp")

N = 300       # rows; JAX pads them to a multiple of its row block
EPS = 1e-6
SHARE = 1e-2  # limit on the share of y's (or dx's) elements that differ
REL = 1e-4    # limit on the relative L2 of each f32 gradient
# (d, dout, GELU): the qkv projection and the adapter at both widths
CASES = [(384, 1152, None), (384, 192, "erf"), (192, 576, None), (192, 192, "erf")]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's outputs by arguments: a compile of an interpret-mode kernel each."""
    return {}


def _inputs(d, dout, seed=0):
    """bf16 x and dy, a weight bf16 holds in PyTorch's [Dout, D] layout, f32
    LN parameters and bias."""
    rng = np.random.default_rng(seed)

    def bf16(a):  # values a bf16 holds exactly, as f32
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()

    return dict(x=bf16(rng.normal(0.2, 1.2, (N, d))), dy=bf16(rng.normal(0, 1, (N, dout))),
                gamma=rng.normal(1, 0.2, d).astype(np.float32),
                beta=rng.normal(0, 0.2, d).astype(np.float32),
                w=bf16(rng.normal(0, d ** -0.5, (dout, d))),
                bias=rng.normal(0, 0.1, dout).astype(np.float32))


def _compile(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax(runs, what, d, dout, mode, monkeypatch):
    """JAX's y (``what`` "fwd") or gradients (dx, dgamma, dbeta, dw [Dout,
    D], db) in f32 numpy."""
    key = (what, d, dout, mode)
    if key in runs:
        return runs[key]
    monkeypatch.setattr(jfm, "_GELU_MODE", mode or "erf")
    a = _inputs(d, dout)
    x, dy = jnp.asarray(a["x"], jnp.bfloat16), jnp.asarray(a["dy"], jnp.bfloat16)
    params = (jnp.asarray(a["gamma"]), jnp.asarray(a["beta"]), jnp.asarray(a["w"].T),
              jnp.asarray(a["bias"]))
    if what == "fwd":
        out = [_compile(lambda x, *p: jfd.fused_ln_dense(x, *p, EPS, mode is not None),
                        x, *params)]
    else:
        def bwd(x, dy, *p):
            _, vjp = jax.vjp(lambda x, *p: jfd.fused_ln_dense(x, *p, EPS, mode is not None),
                             x, *p)
            return vjp(dy)
        out = list(_compile(bwd, x, dy, *params))
    out = [np.asarray(o.astype(jnp.float32)) for o in out]
    if what == "bwd":
        out[3] = out[3].T  # dW in PyTorch's [Dout, D]
    runs[key] = out
    return out


def _port_args(d, dout):
    a = {k: torch.from_numpy(v) for k, v in _inputs(d, dout).items()}
    return (a["x"].bfloat16(), a["gamma"], a["beta"], a["w"].bfloat16(), a["bias"],
            a["dy"].bfloat16())


def _faulty(d, dout, mode, fault):
    """The plain forward (``fault`` "xn_f32": xn kept in f32 before the
    product) or backward (``"dg_f32"``: dxn from the f32 dg; ``"db_bf16"``:
    db summed from the bf16 dg) with one rounding point moved."""
    x, gamma, beta, w, bias, dy = _port_args(d, dout)
    xf, wf = x.float(), w.float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + EPS)
    xhat = xc * inv
    xn = xhat * gamma + beta
    if fault == "xn_f32":
        y = xn @ wf.t() + bias
        return [(gelu(y, mode) if mode else y).bfloat16().float().numpy()]
    xn = xn.bfloat16().float()
    dg = dy.float()
    if mode:
        dg = dg * gelu_erf_grad(xn @ wf.t() + bias)
    dg_lp = dg.bfloat16().float()
    dxn = (dg if fault == "dg_f32" else dg_lp) @ wf
    dyg = dxn * gamma
    dx = inv * (dyg - dyg.mean(-1, keepdim=True) - xhat * (dyg * xhat).mean(-1, keepdim=True))
    out = (dx.bfloat16().float(), (dxn * xhat).sum(0), dxn.sum(0), dg_lp.t() @ xn,
           (dg_lp if fault == "db_bf16" else dg).sum(0))
    return [o.numpy() for o in out]


def _readings(got, want):
    """The first output's share of differing elements, then each f32
    output's relative L2."""
    return [float(np.mean(got[0] != want[0]))] + [
        float(np.linalg.norm(g - w) / np.linalg.norm(w)) for g, w in zip(got[1:], want[1:])]


@pytest.mark.parametrize("d,dout,mode", CASES + [(384, 192, "sigmoid"), (192, 192, "sigmoid")])
def test_forward_matches_jax(jax_runs, monkeypatch, d, dout, mode):
    """``fused_ln_dense_plain`` against ``_fwd_kernel``: y's share of
    differing elements."""
    x, gamma, beta, w, bias, _ = _port_args(d, dout)
    got = [fused_ln_dense_plain(x, gamma, beta, w, bias, EPS, mode).float().numpy()]
    r = _readings(got, _jax(jax_runs, "fwd", d, dout, mode, monkeypatch))
    assert r[0] <= SHARE, r


@pytest.mark.parametrize("d,dout,mode", CASES)
def test_backward_matches_jax(jax_runs, monkeypatch, d, dout, mode):
    """``fused_ln_dense_bwd_plain`` against ``_bwd_kernel`` through the VJP
    of ``fused_ln_dense``: dx's share of differing elements, the relative L2
    of dgamma, dbeta, dW and db."""
    x, gamma, beta, w, bias, dy = _port_args(d, dout)
    got = [o.float().numpy() for o in
           fused_ln_dense_bwd_plain(x, gamma, beta, w, bias, dy, EPS, mode)]
    r = _readings(got, _jax(jax_runs, "bwd", d, dout, mode, monkeypatch))
    assert r[0] <= SHARE and max(r[1:]) <= REL, r


@pytest.mark.parametrize("what,mode,fault,output", [
    ("fwd", None, "xn_f32", 0), ("fwd", "erf", "xn_f32", 0),
    ("bwd", "erf", "dg_f32", 0), ("bwd", "erf", "db_bf16", 4)])
def test_controls_exceed_the_limits(jax_runs, monkeypatch, what, mode, fault, output):
    """A moved rounding point reaches its limit at D = 384: xn kept in f32
    moves y, dg kept in f32 before dxn moves dx, db from the bf16 dg moves
    db; the other outputs of each control stay sound (dxn from the f32 dg
    also moves dgamma and dbeta, which it feeds)."""
    dout = 1152 if mode is None else 192
    r = _readings(_faulty(384, dout, mode, fault),
                  _jax(jax_runs, what, 384, dout, mode, monkeypatch))
    limits = [SHARE] + [REL] * 4
    assert r[output] > limits[output], r
    assert all(v <= lim for i, (v, lim) in enumerate(zip(r, limits))
               if i != output and not (fault == "dg_f32" and i in (1, 2))), r
