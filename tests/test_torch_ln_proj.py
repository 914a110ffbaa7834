"""The LN backward's and the residual projection's rounding points against the
JAX package, on the CPU.

JAX's LN backward (``intentbev/ops/layernorm.py`` ``_bwd_kernel``, behind the
custom VJP of ``fused_layernorm``) takes dy (bf16) and the forward's saved
xhat (bf16) and inv (f32), computes dx = inv * (dy*g - mean(dy*g) - xhat *
mean(dy*g*xhat)) in f32 and rounds it once, and sums dgamma = sum dy*xhat
and dbeta = sum dy in f32. JAX's projection (``experimental/fused_proj.py``
``_fwd_kernel`` / ``_bwd_kernel``) rounds y once after (x W + b) * gate +
residual in f32, and in the backward rounds dyg = dy * gate to bf16 before
dx = dyg_c W^T and dW = x^T dyg_c while db sums the f32 dyg. The port's plain
versions (the CPU path, and the card's oracle for the kernels of
``csrc/layernorm.cu`` and ``csrc/fused_proj.cu``) are held here against them
in bf16, at the model widths: the LN at D = 384 and 192 over 300 rows (JAX
pads them to its 1024-row block), the projection at (d_in, d_out) = (384,
384) and (192, 384) over 2 x 300 rows with a per-sample gate (JAX pads them
to its 512-row block). JAX runs in interpret mode, compiled with
``xla_allow_excess_precision`` off (else XLA's CPU backend may keep a bf16
value in f32 where a dot reads it: dyg_c). JAX gets the projection's weight
in f32 holding values bf16 holds exactly, so that its dW comes back in f32
(the custom VJP casts it to the weight's dtype); its products are then those
of bf16 operands.

Readings: the share of the LN's dx's and the projection's y's and dx's
elements that differ, limit ``SHARE`` = 1 % (the same f32 quantities summed
in another order tip a few values to the neighbouring bf16; sound readings
0.0009-0.0017 % of the LN's dx, <= 0.0026 % of y, 0 of dx), and the relative
L2 of the f32 dgamma, dbeta, dW and db, limit ``REL`` = 1e-4 (f32 sums in
another order, and an xhat that may differ by one bf16 ulp where the two
means round apart; sound readings <= 5.3e-7). A relative L2 cannot see a
moved rounding point; the share can. The controls, each one plausible
fault, must exceed a limit and leave the other outputs sound: the LN
backward without its mean(dyg * xhat) term (90-93 % of dx), the
projection's Dense output rounded to bf16 before the gate and the residual
(the model's unfused rounding: 25.7-25.9 % of y), and db summed from the
rounded dyg_c (db 1.6e-3).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev_torch.ops.experimental import (  # noqa: E402
    fused_proj_bwd_plain, fused_proj_fwd_plain)
from intentbev_torch.ops.layernorm import layernorm_bwd_plain, layernorm_train_plain  # noqa: E402

jln = importlib.import_module("intentbev.ops.layernorm")
jproj = importlib.import_module("intentbev.ops.experimental.fused_proj")

N = 300       # rows (a sample's, for the projection); JAX pads them to its row block
EPS = 1e-6
SHARE = 1e-2  # limit on the share of a bf16 output's elements that differ
REL = 1e-4    # limit on the relative L2 of each f32 gradient
LN_WIDTHS = [384, 192]
PROJ_WIDTHS = [(384, 384), (192, 384)]  # (d_in, d_out)


def _bf16(a):
    """Values a bf16 holds exactly, as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def _compile(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)


def _share(got, want):
    return float(np.mean(got != want))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's outputs by case: a compile of interpret-mode kernels each."""
    return {}


# ------------------------------------------------------------------- LN --

def _ln_inputs(d, seed=0):
    rng = np.random.default_rng(seed)
    return dict(x=_bf16(rng.normal(0.3, 1.5, (N, d))), dy=_bf16(rng.normal(0, 1, (N, d))),
                gamma=rng.normal(1, 0.3, d).astype(np.float32),
                beta=rng.normal(0, 0.3, d).astype(np.float32))


def _jax_ln(runs, d):
    """JAX's (dx, dgamma, dbeta) through the VJP of ``fused_layernorm``."""
    if ("ln", d) not in runs:
        a = _ln_inputs(d)
        x, dy = jnp.asarray(a["x"], jnp.bfloat16), jnp.asarray(a["dy"], jnp.bfloat16)

        def bwd(x, dy, g, b):
            _, vjp = jax.vjp(lambda x, g, b: jln.fused_layernorm(x, g, b, EPS), x, g, b)
            return vjp(dy)

        out = _compile(bwd, x, dy, jnp.asarray(a["gamma"]), jnp.asarray(a["beta"]))
        runs[("ln", d)] = [np.asarray(o.astype(jnp.float32)) for o in out]
    return runs[("ln", d)]


def _port_ln(d, no_m2=False):
    """The port's plain training forward, then its plain backward (or, with
    ``no_m2``, the control: dx without the mean(dyg * xhat) term)."""
    a = {k: torch.from_numpy(v) for k, v in _ln_inputs(d).items()}
    x, dy = a["x"].bfloat16(), a["dy"].bfloat16()
    _, xhat, inv = layernorm_train_plain(x, a["gamma"], a["beta"], EPS)
    dx, dgamma, dbeta = layernorm_bwd_plain(dy, xhat, inv, a["gamma"])
    if no_m2:
        dyg = dy.float() * a["gamma"]
        dx = (inv[:, None] * (dyg - dyg.mean(-1, keepdim=True))).bfloat16()
    return [t.float().numpy() for t in (dx, dgamma, dbeta)]


def _ln_readings(got, want):
    return [_share(got[0], want[0]), _rel(got[1], want[1]), _rel(got[2], want[2])]


@pytest.mark.parametrize("d", LN_WIDTHS)
def test_layernorm_backward_matches_jax(jax_runs, d):
    """``layernorm_train_plain`` then ``layernorm_bwd_plain`` against JAX's
    ``_fwd_kernel`` / ``_bwd_kernel``: dx's share of differing elements, the
    relative L2 of dgamma and dbeta."""
    r = _ln_readings(_port_ln(d), _jax_ln(jax_runs, d))
    assert r[0] <= SHARE and max(r[1:]) <= REL, r


@pytest.mark.parametrize("d", LN_WIDTHS)
def test_layernorm_backward_control_exceeds_the_limit(jax_runs, d):
    """Without the mean(dyg * xhat) term dx moves past the share limit;
    dgamma and dbeta, which do not take it, stay sound."""
    r = _ln_readings(_port_ln(d, no_m2=True), _jax_ln(jax_runs, d))
    assert r[0] > SHARE and max(r[1:]) <= REL, r


# ----------------------------------------------------------- projection --

def _proj_inputs(d_in, d_out, seed=1):
    rng = np.random.default_rng(seed)
    return dict(x=_bf16(rng.normal(0, 1, (2, N, d_in))),
                r=_bf16(rng.normal(0, 1, (2, N, d_out))), dy=_bf16(rng.normal(0, 1, (2, N, d_out))),
                w=_bf16(rng.normal(0, d_in ** -0.5, (d_in, d_out))),
                b=rng.normal(0, 0.1, d_out).astype(np.float32),
                gate=rng.uniform(0.5, 1.5, (2, 1)).astype(np.float32))  # per sample


def _jax_proj(runs, d_in, d_out):
    """JAX's y, then (dx, dW, db) through the VJP of ``fused_dense_residual``."""
    if ("proj", d_in, d_out) not in runs:
        a = _proj_inputs(d_in, d_out)
        x, r, dy = (jnp.asarray(a[k], jnp.bfloat16) for k in ("x", "r", "dy"))
        w, b, gate = (jnp.asarray(a[k]) for k in ("w", "b", "gate"))

        def both(x, w, b, r, gate, dy):
            y, vjp = jax.vjp(lambda x, w, b: jproj.fused_dense_residual(x, w, b, r, gate),
                             x, w, b)
            return (y, *vjp(dy))

        out = _compile(both, x, w, b, r, gate, dy)
        out = [np.asarray(o.astype(jnp.float32)) for o in out]
        runs[("proj", d_in, d_out)] = [out[0].reshape(-1, d_out), out[1].reshape(-1, d_in),
                                       out[2], out[3]]
    return runs[("proj", d_in, d_out)]


def _port_proj(d_in, d_out, fault=None):
    """The port's plain forward and backward over rows: [y, dx, dW, db]
    (``fault`` "dense_bf16": the Dense output rounded before the gate and the
    residual; "db_bf16": db summed from the rounded dyg)."""
    a = {k: torch.from_numpy(v) for k, v in _proj_inputs(d_in, d_out).items()}
    x2, r2, dy2 = (a[k].bfloat16().reshape(-1, a[k].shape[-1]) for k in ("x", "r", "dy"))
    w = a["w"].bfloat16()
    gate2 = a["gate"].repeat_interleave(N, 0)  # [2 N, 1]
    y = fused_proj_fwd_plain(x2, w, a["b"], r2, gate2)
    if fault == "dense_bf16":
        dense = (x2.float() @ w.float() + a["b"]).bfloat16().float()
        y = (dense * gate2 + r2.float()).bfloat16()
    dx, dw, db = fused_proj_bwd_plain(x2, w, dy2, gate2)
    if fault == "db_bf16":
        db = (dy2.float() * gate2).bfloat16().float().sum(0)
    return [t.float().numpy() for t in (y, dx, dw, db)]


def _proj_readings(got, want):
    """y's and dx's shares of differing elements, dW's and db's relative L2."""
    return [_share(got[0], want[0]), _share(got[1], want[1]), _rel(got[2], want[2]),
            _rel(got[3], want[3])]


@pytest.mark.parametrize("d_in,d_out", PROJ_WIDTHS)
def test_projection_matches_jax(jax_runs, d_in, d_out):
    """``fused_proj_fwd_plain`` / ``fused_proj_bwd_plain`` against JAX's
    ``_fwd_kernel`` / ``_bwd_kernel``: y's and dx's shares of differing
    elements, the relative L2 of dW and db."""
    r = _proj_readings(_port_proj(d_in, d_out), _jax_proj(jax_runs, d_in, d_out))
    assert max(r[:2]) <= SHARE and max(r[2:]) <= REL, r


@pytest.mark.parametrize("fault,output", [("dense_bf16", 0), ("db_bf16", 3)])
@pytest.mark.parametrize("d_in,d_out", PROJ_WIDTHS)
def test_projection_controls_exceed_the_limits(jax_runs, d_in, d_out, fault, output):
    """A moved rounding point reaches its limit: the Dense output rounded
    before the gate and the residual moves y; db from the rounded dyg moves
    db. The other outputs of each control stay sound."""
    r = _proj_readings(_port_proj(d_in, d_out, fault), _jax_proj(jax_runs, d_in, d_out))
    limits = [SHARE, SHARE, REL, REL]
    assert r[output] > limits[output], r
    assert all(v <= lim for i, (v, lim) in enumerate(zip(r, limits)) if i != output), r
