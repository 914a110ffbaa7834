"""The kernels of ViT-B's serving variants (D=768, hidden 3072) against the
JAX package on the CPU.

Under the four switches of ``VIT_SERVING_VARIANTS`` ViT-B serves through
rows 13, 14, 15 and 17 at D=768 on the card: C ``use_fused_layernorm=False``
through row 13 (the MLP without LN; ``csrc/fused_ln_mlp.cu``'s
``ln_mlp_wide_kernel`` without its LN), B ``fuse_ln_dense`` through row 14
(the qkv projection, Dout 2304, and the adapters, Dout 192 with a GELU;
``csrc/fused_ln_dense.cu``'s forward on 64-row blocks whose consumers split
the columns), D ``fuse_patch_embed`` through row 15
(``csrc/patch_embed.cu``, four blocks a group of patch rows) and A
``serving_int8`` through row 17 (``csrc/fused_mlp_int8.cu``, pass 2 once
for each half of the output columns). Their plain versions, the CPU path
and the card's oracle, are held here against JAX's Pallas kernels in
interpret mode, in bf16, with the cases, limits and controls the narrow
widths' files use (300 rows from a numpy seed, JAX padding them to its
row blocks):

- row 13 (``fused_mlp._fwd``, both GELUs, no gate: the serving form) and
  row 14 (``fused_ln_dense._fwd_kernel``: qkv without GELU, the adapter
  with each GELU), as ``tests/test_torch_ln_mlp_fwd.py`` and
  ``tests/test_torch_ln_dense.py`` hold them: the share of y's elements
  that differ, limit 1 %; controls h kept in f32 before fc2 and xn kept
  in f32 before the product;
- row 15 (``patch_embed._kernel`` on [2, 40, 80, 290]), as
  ``tests/test_torch_patch_embed.py``: the share of the tokens' elements
  that differ, limit 1 %; control the sum rounded to bf16 before the bias;
- row 17 (``fused_mlp_int8``, both GELUs, JAX compiled with ``algsimp``
  off), as ``tests/test_torch_int8_mlp.py``: the share of y's elements that
  differ, limit 0.1 %; controls h rounded to bf16 before its codes, one hs
  per 32 rows, x's codes from x * (1 / xs).

The model under each switch at this width (a depth-1 ViT-B against JAX's)
and its int8 codes are in ``tests/test_torch_vit_base.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_int8_mlp as int8_cases  # noqa: E402
import test_torch_ln_dense as dense_cases  # noqa: E402
import test_torch_ln_mlp_fwd as mlp_cases  # noqa: E402
from intentbev.ops.patch_embed import patch_embed_matmul as jax_patch_embed  # noqa: E402
from intentbev_torch.ops.fused_ln_dense import fused_ln_dense_plain  # noqa: E402
from intentbev_torch.ops.fused_ln_mlp import gelu  # noqa: E402
from intentbev_torch.ops.fused_mlp_int8 import fused_mlp_int8_plain  # noqa: E402
from intentbev_torch.ops.patch_embed import patch_embed_plain  # noqa: E402
from test_torch_patch_embed import C, P, _bf16, _compile  # noqa: E402

D, HIDDEN = 768, 3072
SHARE = 1e-2       # limit on the share of y's elements that differ (rows 13-15)
INT8_SHARE = 1e-3  # and of row 17's
MLP_SEED = 2       # the seed of test_torch_ln_mlp_fwd's cases of the MLP without LN
# row 14's cases: (Dout, GELU): the qkv projection and the adapter
DENSE_CASES = [(3 * D, None), (192, "erf"), (192, "sigmoid")]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's outputs by arguments: a compile of an interpret-mode kernel each."""
    return {}


def _shares(got, want):
    return [float(np.mean(np.asarray(g) != np.asarray(w))) for g, w in zip(got, want)]


# -- row 13 ---------------------------------------------------------------------

def _mlp_h_f32(gelu_mode):
    """The MLP without LN with the control's fault: h kept in f32 before fc2."""
    a = {k: torch.from_numpy(v) for k, v in mlp_cases._inputs(MLP_SEED, D, False).items()
         if k != "ln"}
    y = gelu(a["x"] @ a["w1"] + a["b1"], gelu_mode) @ a["w2"] + a["b2"] + a["res"]
    return (y.bfloat16().float().numpy(),)


@pytest.mark.parametrize("gelu_mode", ["sigmoid", "erf"])
def test_row13_mlp_without_ln_matches_jax(jax_runs, monkeypatch, gelu_mode):
    """``fused_mlp_plain`` (the serving tail, no gate) at D=768, hidden
    3072, against ``fused_mlp._fwd``."""
    assert 4 * D == HIDDEN
    want = mlp_cases._jax(jax_runs, "mlp", gelu_mode, MLP_SEED, D, False, monkeypatch)
    shares = _shares(mlp_cases._port("mlp", gelu_mode, MLP_SEED, D, False), want)
    print(f"row 13 D={D} {gelu_mode}: share {shares}")
    assert max(shares) <= SHARE, shares


def test_row13_control_exceeds_the_limit(jax_runs, monkeypatch):
    """h kept in f32 before fc2 moves y past the limit."""
    want = mlp_cases._jax(jax_runs, "mlp", "sigmoid", MLP_SEED, D, False, monkeypatch)
    shares = _shares(_mlp_h_f32("sigmoid"), want)
    print(f"row 13 D={D} control (h kept in f32): share {shares}")
    assert min(shares) > SHARE, shares


# -- row 14 ---------------------------------------------------------------------

@pytest.mark.parametrize("dout,mode", DENSE_CASES)
def test_row14_ln_dense_matches_jax(jax_runs, monkeypatch, dout, mode):
    """``fused_ln_dense_plain`` at D=768 against ``_fwd_kernel``: y's share
    of differing elements."""
    x, gamma, beta, w, bias, _ = dense_cases._port_args(D, dout)
    got = [fused_ln_dense_plain(x, gamma, beta, w, bias, dense_cases.EPS, mode).float().numpy()]
    shares = _shares(got, dense_cases._jax(jax_runs, "fwd", D, dout, mode, monkeypatch))
    print(f"row 14 D={D} Dout {dout} {mode}: share {shares}")
    assert shares[0] <= SHARE, shares


@pytest.mark.parametrize("dout,mode", DENSE_CASES[:2])
def test_row14_control_exceeds_the_limit(jax_runs, monkeypatch, dout, mode):
    """xn kept in f32 before the product moves y past the limit."""
    want = dense_cases._jax(jax_runs, "fwd", D, dout, mode, monkeypatch)
    shares = _shares(dense_cases._faulty(D, dout, mode, "xn_f32"), want)
    print(f"row 14 D={D} Dout {dout} {mode} control (xn kept in f32): share {shares}")
    assert shares[0] > SHARE, shares


# -- row 15 ---------------------------------------------------------------------

def test_row15_patch_embed_matches_jax():
    """``patch_embed_plain`` at D=768 on two samples of 5 x 10 patches of 290
    channels against ``patch_embed_matmul``; control: the f32 sum rounded to
    bf16 before the bias."""
    rng = np.random.default_rng(0)
    x = _bf16(rng.normal(0, 1, (2, 40, 80, C)))
    kern = _bf16(rng.normal(0, 0.02, (P, P, C, D)))
    bias = rng.normal(0, 0.1, D).astype(np.float32)
    want = _compile(lambda x, k, b: jax_patch_embed(x, k, b, P), jnp.asarray(x, jnp.bfloat16),
                    jnp.asarray(kern, jnp.bfloat16), jnp.asarray(bias))
    want = np.asarray(want.astype(jnp.float32))
    xt, kt, bt = (torch.from_numpy(a) for a in (x, kern, bias))
    got = patch_embed_plain(xt.bfloat16(), kt.bfloat16(), bt, P)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 50, D)
    ctrl = patch_embed_plain(xt.bfloat16(), kt.bfloat16(), torch.zeros_like(bt), P)
    ctrl = (ctrl.float() + bt).bfloat16()
    (sound,), (control,) = (_shares([t.float().numpy()], [want]) for t in (got, ctrl))
    print(f"row 15 D={D}: share {sound:.4%}, control {control:.4%}")
    assert sound < SHARE
    assert control >= SHARE


# -- row 17 ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", int8_cases.MODES)
def test_row17_int8_mlp_matches_jax(jax_runs, monkeypatch, mode):
    """``fused_mlp_int8_plain`` at D=768, hidden 3072, against JAX's
    ``fused_mlp_int8``: y's share of differing elements."""
    want = int8_cases._jax(jax_runs, mode, D, monkeypatch)
    got = fused_mlp_int8_plain(*int8_cases._port_args(D), mode).float().numpy()
    assert got.shape == want.shape == (int8_cases.N, D)
    share = float(np.mean(got != want))
    print(f"row 17 D={D} {mode}: share {share:.5f}")
    assert share <= INT8_SHARE, f"{share:.5f} of y's elements differ from JAX's"


@pytest.mark.parametrize("fault", int8_cases.FAULTS)
def test_row17_control_exceeds_the_limit(jax_runs, monkeypatch, fault):
    """Each fault moves more of y than the limit (the sigmoid GELU)."""
    want = int8_cases._jax(jax_runs, "sigmoid", D, monkeypatch)
    share = float(np.mean(int8_cases._faulty(D, "sigmoid", fault) != want))
    print(f"row 17 D={D} control ({fault}): share {share:.5f}")
    assert share > INT8_SHARE, f"control {fault}: only {share:.5f} of y's elements differ"
