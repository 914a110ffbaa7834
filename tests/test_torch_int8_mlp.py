"""Row 17, the W8A8 serving MLP: its rounding points against the JAX package, on the CPU.

JAX's kernel (``intentbev/ops/fused_mlp_int8.py`` ``_fwd_kernel``) takes
each row's int8 codes of x with an f32 scale xs = max(max|x|, 1e-8) / 127
and an IEEE division x / xs, rescales the int32 product as ((acc * xs) * s1)
+ b1 in f32, takes the GELU in f32, quantizes each row of h with its own
scale hs over the whole hidden row, rescales the second product the same
way, adds the residual in f32 and rounds y once to bf16. The port's plain
version ``fused_mlp_int8_plain`` (the CPU path, and the card's oracle for
``csrc/fused_mlp_int8.cu``) is held here against it: D=384 (hidden 1536)
and D=192 (hidden 768), 300 rows of varied scale from a numpy seed (JAX
pads them to its 256-row blocks), x and the residual in bf16, the codes of
f32 weights, both GELU forms, JAX in interpret mode. JAX is compiled with
two XLA rewrites off, as ``tests/test_torch_experimental.py`` does: the
algebraic simplifier turns ``/ 127.0`` into a multiplication (which moves
scales by an ulp and flips codes at ties), and excess precision would keep
bf16 values in f32.

The reading is the share of y's elements that differ, limit ``SHARE`` =
0.1 %. Sound readings: 0.003-0.005 % (JAX's A&S erf, 1.5e-7 from ``erff``,
and summation order move a code now and then). An f32 tolerance on y
cannot see a moved code; the share can: the controls, each the plain
version with one fault, must exceed the limit: h rounded to bf16 before
its codes (~60 %), one hs per 32 rows (~88 %) and x's codes taken as x *
(1 / xs) rather than x / xs (5.0-7.0 %).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from intentbev_torch.ops.fused_ln_mlp import gelu  # noqa: E402
from intentbev_torch.ops.fused_mlp_int8 import fused_mlp_int8_plain  # noqa: E402
from intentbev_torch.ops.int8 import int_matmul, quantize_linear, quantize_rows  # noqa: E402

jfm = importlib.import_module("intentbev.ops.fused_mlp")
jfi = importlib.import_module("intentbev.ops.fused_mlp_int8")

N = 300        # rows; JAX pads them to a multiple of its 256-row block
SHARE = 1e-3   # limit on the share of y's elements that differ
AS_WRITTEN = {"xla_disable_hlo_passes": "algsimp", "xla_allow_excess_precision": False}
WIDTHS = (384, 192)
MODES = ("sigmoid", "erf")
FAULTS = ("h_bf16", "block_scale", "reciprocal")


def _inputs(d, seed=0):
    """x (rows of varied scale) and the residual as values bf16 holds
    exactly, f32 weights in JAX's [in, out] layout, f32 biases."""
    rng = np.random.default_rng(seed)
    hid = 4 * d

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()

    x = bf16(rng.normal(0, 1, (N, d)) * np.exp(0.5 * rng.normal(0, 1, (N, 1))))
    res = bf16(rng.normal(0, 1, (N, d)))
    w1 = rng.normal(0, d ** -0.5, (d, hid)).astype(np.float32)
    w2 = rng.normal(0, hid ** -0.5, (hid, d)).astype(np.float32)
    b1, b2 = (rng.normal(0, 0.1, n).astype(np.float32) for n in (hid, d))
    return dict(x=x, res=res, w1=w1, b1=b1, w2=w2, b2=b2)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's y by (GELU form, width): a compile of the interpret-mode kernel each."""
    return {}


def _jax(runs, mode, d, monkeypatch):
    if (mode, d) not in runs:
        monkeypatch.setattr(jfm, "_GELU_MODE", mode)
        a = _inputs(d)
        args = (jnp.asarray(a["x"], jnp.bfloat16), jnp.asarray(a["w1"]), jnp.asarray(a["b1"]),
                jnp.asarray(a["w2"]), jnp.asarray(a["b2"]), jnp.asarray(a["res"], jnp.bfloat16))
        with pltpu.force_tpu_interpret_mode():
            # a new function each time: jit caches its trace by the function,
            # which would keep the GELU of the first call
            fn = jax.jit(lambda *t: jfi.fused_mlp_int8(*t))
            y = fn.lower(*args).compile(compiler_options=AS_WRITTEN)(*args)
        runs[(mode, d)] = np.asarray(y.astype(jnp.float32))
    return runs[(mode, d)]


def _port_args(d):
    """The plain version's arguments: bf16 x and residual, the codes and
    scales of the weights in PyTorch's [out, in] layout, f32 biases."""
    t = {k: torch.from_numpy(v) for k, v in _inputs(d).items()}
    w1q, s1 = quantize_linear(t["w1"].t().contiguous())
    w2q, s2 = quantize_linear(t["w2"].t().contiguous())
    return t["x"].bfloat16(), w1q, s1, t["b1"], w2q, s2, t["b2"], t["res"].bfloat16()


def _faulty(d, mode, fault):
    """The plain version with one fault: ``h_bf16`` (h rounded to bf16 before
    its codes), ``block_scale`` (one hs per 32 rows) or ``reciprocal`` (x's
    codes from x * (1 / xs))."""
    x, w1q, s1, b1, w2q, s2, b2, res = _port_args(d)
    xf = x.float()
    if fault == "reciprocal":
        xs = xf.abs().amax(-1, keepdim=True).clamp(min=1e-8) / torch.full((), 127.0)
        xq = torch.clamp(torch.round(xf * (1.0 / xs)), -127, 127)
    else:
        xq, xs = quantize_rows(xf)
    h = gelu(int_matmul(xq, w1q.t()) * xs * s1 + b1, mode)
    if fault == "h_bf16":
        h = h.bfloat16().float()
    if fault == "block_scale":
        amax = torch.nn.functional.pad(h.abs().amax(-1), (0, -N % 32)).reshape(-1, 32).amax(-1)
        hs = amax.repeat_interleave(32)[:N, None].clamp(min=1e-8) / torch.full((), 127.0)
        hq = torch.clamp(torch.round(h / hs), -127, 127)
    else:
        hq, hs = quantize_rows(h)
    y = int_matmul(hq, w2q.t()) * hs * s2 + b2
    return (y + res.float()).bfloat16().float().numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_matches_jax(jax_runs, d, mode, monkeypatch):
    want = _jax(jax_runs, mode, d, monkeypatch)
    got = fused_mlp_int8_plain(*_port_args(d), mode).float().numpy()
    assert got.shape == want.shape == (N, d)
    share = float(np.mean(got != want))
    assert share <= SHARE, f"{share:.5f} of y's elements differ from JAX's"


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", WIDTHS)
def test_control_exceeds_limit(jax_runs, d, mode, fault, monkeypatch):
    want = _jax(jax_runs, mode, d, monkeypatch)
    share = float(np.mean(_faulty(d, mode, fault) != want))
    assert share > SHARE, f"control {fault}: only {share:.5f} of y's elements differ"
