"""The backwards of ViT-B's training variants (D=768) against the JAX package
on the CPU.

Under B ``fuse_ln_dense`` and C ``use_fused_layernorm=False`` ViT-B trains
through the backwards of row 14 (the LN + dense pair: the qkv projection,
Dout 2304 without GELU, and the adapters, Dout 192 with the erf GELU;
``csrc/fused_ln_dense.cu``'s ``ln_dense_bwd_wide_kernel``, 64-row blocks
whose two consumers split dxn's columns) and of row 13 (the MLP without LN;
``csrc/fused_ln_mlp.cu``'s two row kernels ``ln_mlp_dh_kernel`` and
``ln_mlp_bwd_wide_kernel`` without their LN). Their plain versions, the CPU
path and the card's oracle, are held here against JAX's Pallas kernels in
interpret mode, in bf16, compiled with ``xla_allow_excess_precision`` off,
by the cases of the narrow widths' files (300 rows from a numpy seed, JAX
padding them to its row blocks, f32 weights that bf16 holds exactly):

- row 13 (``fused_mlp._bwd_kernel`` through the VJP of ``fused_mlp``) gated
  and not, hidden 3072, as ``tests/test_torch_ln_mlp_bwd.py`` holds it: dh's
  share of differing elements, limit ``SHARE`` = 1 %, and the f32
  gradients' relative L2, limit ``REL`` = 3e-4 (the limit of
  ``tests/test_torch_vit_base_train.py`` at this width: the sound readings
  grow with the width); controls dg kept in f32 before dh = dg W1 (dh's
  share) and h kept in f32 in dW2 (dW2's relative L2);
- row 14 (``fused_ln_dense._bwd_kernel`` through the VJP of
  ``fused_ln_dense``), qkv and the adapter, as ``tests/test_torch_ln_dense.py``
  holds it: dx's share, limit 1 %, and the f32 gradients' relative L2,
  limit 1e-4; control xn kept in f32 (its dW's relative L2; with the GELU
  also g, so dx's share).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_ln_dense as dense_cases  # noqa: E402
import test_torch_ln_mlp_bwd as bwd_cases  # noqa: E402
from intentbev_torch.ops.fused_ln_dense import fused_ln_dense_bwd_plain  # noqa: E402
from intentbev_torch.ops.fused_ln_mlp import gelu, gelu_erf_grad  # noqa: E402
from test_torch_vit_base_train import REL  # noqa: E402

D, HIDDEN = 768, 3072
MLP_SEED = 1  # the seed of test_torch_ln_mlp_bwd's cases of the MLP without LN
# row 14's cases: (Dout, GELU): the qkv projection and the adapter
DENSE_CASES = [(3 * D, None), (192, "erf")]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's outputs by case: a compile of interpret-mode kernels each."""
    return {}


# -- row 13 ---------------------------------------------------------------------

def _mlp_faulty(fault):
    """The gated backward of the MLP without LN with one rounding point
    moved: ``"dg_f32"`` (dh from the f32 dg) or ``"h_f32"`` (dW2 from the
    f32 h); (dh, dw1, db1, dw2, db2) as f32 numpy."""
    h, _, _, w1, b1, w2, gate, dy = bwd_cases._port_args(MLP_SEED, D, True)
    hf, w1f, w2f = h.float(), w1.float(), w2.float()
    g = hf @ w1f.t() + b1
    dye = dy.float() * gate[:, None]
    dye_lp = dye.bfloat16().float()
    dg = (dye_lp @ w2f) * gelu_erf_grad(g)
    dg_lp = dg.bfloat16().float()
    act = gelu(g, "erf")
    act = act if fault == "h_f32" else act.bfloat16().float()
    out = ((dg if fault == "dg_f32" else dg_lp) @ w1f, dg_lp.t() @ hf, dg.sum(0),
           dye_lp.t() @ act, dye.sum(0))
    return [o.bfloat16().float().numpy() if i == 0 else o.numpy() for i, o in enumerate(out)]


@pytest.mark.parametrize("gated", [True, False])
def test_row13_backward_matches_jax(jax_runs, monkeypatch, gated):
    """``fused_mlp_bwd_plain`` at D=768, hidden 3072, against
    ``fused_mlp._bwd_kernel`` through the VJP of ``fused_mlp``."""
    assert 4 * D == HIDDEN
    r = bwd_cases._readings(bwd_cases._port(False, MLP_SEED, D, gated),
                            bwd_cases._jax(jax_runs, False, MLP_SEED, D, gated, monkeypatch))
    print(f"row 13 backward D={D} gated={gated}: dh share {r[0]:.4%}, relative L2 {r[1:]}")
    assert r[0] <= bwd_cases.SHARE and max(r[1:]) <= REL, r


@pytest.mark.parametrize("fault,output", [("dg_f32", 0), ("h_f32", 3)])
def test_row13_controls_exceed_the_limits(jax_runs, monkeypatch, fault, output):
    """dg kept in f32 before dh = dg W1 moves dh's share, h kept in f32
    moves dW2; the other outputs of each control stay sound."""
    want = bwd_cases._jax(jax_runs, False, MLP_SEED, D, True, monkeypatch)
    r = bwd_cases._readings(_mlp_faulty(fault), want)
    print(f"row 13 backward D={D} control ({fault}): {r}")
    limits = [bwd_cases.SHARE] + [REL] * 4
    assert r[output] > limits[output], r
    assert all(v <= lim for i, (v, lim) in enumerate(zip(r, limits)) if i != output), r


# -- row 14 ---------------------------------------------------------------------

def _dense_xn_f32(dout, mode):
    """The plain backward with xn kept in f32 before its products (g with
    the GELU, and dW); (dx, dgamma, dbeta, dw, db) as f32 numpy."""
    x, gamma, beta, w, bias, dy = dense_cases._port_args(D, dout)
    xf, wf = x.float(), w.float()
    xc = xf - xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + dense_cases.EPS)
    xhat = xc * inv
    xn = xhat * gamma + beta
    dg = dy.float()
    if mode:
        dg = dg * gelu_erf_grad(xn @ wf.t() + bias)
    dg_lp = dg.bfloat16().float()
    dxn = dg_lp @ wf
    dyg = dxn * gamma
    dx = inv * (dyg - dyg.mean(-1, keepdim=True) - xhat * (dyg * xhat).mean(-1, keepdim=True))
    out = (dx.bfloat16().float(), (dxn * xhat).sum(0), dxn.sum(0), dg_lp.t() @ xn, dg.sum(0))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("dout,mode", DENSE_CASES)
def test_row14_backward_matches_jax(jax_runs, monkeypatch, dout, mode):
    """``fused_ln_dense_bwd_plain`` at D=768 against ``_bwd_kernel`` through
    the VJP of ``fused_ln_dense``: dx's share of differing elements, the
    relative L2 of dgamma, dbeta, dW and db."""
    x, gamma, beta, w, bias, dy = dense_cases._port_args(D, dout)
    got = [o.float().numpy() for o in
           fused_ln_dense_bwd_plain(x, gamma, beta, w, bias, dy, dense_cases.EPS, mode)]
    r = dense_cases._readings(got, dense_cases._jax(jax_runs, "bwd", D, dout, mode, monkeypatch))
    print(f"row 14 backward D={D} Dout {dout} {mode}: dx share {r[0]:.4%}, relative L2 {r[1:]}")
    assert r[0] <= dense_cases.SHARE and max(r[1:]) <= dense_cases.REL, r


@pytest.mark.parametrize("dout,mode", DENSE_CASES)
def test_row14_control_exceeds_the_limits(jax_runs, monkeypatch, dout, mode):
    """xn kept in f32 before its products moves dW past the limit (and,
    through g, the adapter's dx and db)."""
    want = dense_cases._jax(jax_runs, "bwd", D, dout, mode, monkeypatch)
    r = dense_cases._readings(_dense_xn_f32(dout, mode), want)
    print(f"row 14 backward D={D} Dout {dout} {mode} control (xn kept in f32): {r}")
    assert r[3] > dense_cases.REL, r
    if mode is None:  # dx, dgamma, dbeta and db do not read xn
        assert r[0] <= dense_cases.SHARE and max(r[1], r[2], r[4]) <= dense_cases.REL, r
