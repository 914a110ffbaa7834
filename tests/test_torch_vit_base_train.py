"""ViT-B's training step (D=768, 12 heads of 64, hidden 3072) against the
JAX package on the CPU, and the widths each kernel entry takes.

On the card the training step's kernels take this width (rows 6-9;
``csrc/fused_ln_mlp.cu``'s ``ln_mlp_wide_kernel`` for row 6, its two row
kernels ``ln_mlp_dh_kernel`` and ``ln_mlp_bwd_wide_kernel`` for row 7, and
``csrc/layernorm.cu``'s 24-values-a-lane layouts for rows 8 and 9). Their
plain versions, the CPU path and the card's oracle, are held here against
JAX's Pallas kernels in interpret mode, in bf16, compiled with
``xla_allow_excess_precision`` off, by the cases and limits that
``tests/test_torch_ln_mlp_fwd.py``, ``tests/test_torch_ln_mlp_bwd.py`` and
``tests/test_torch_ln_proj.py`` use at 384 and 192 (300 rows from a numpy
seed): row 6 (``_fwd``) gated and not, y's share of differing elements
(control: h kept in f32 before fc2); row 7 (``_bwd_kernel`` through the VJP
of ``fused_ln_mlp``) gated and not, dx's share and the f32 gradients'
relative L2, limit ``REL`` (controls: dg kept in f32 before dxn, h kept in
f32 in dW2, db1 summed from the bf16 dg); rows 8 and 9 (the VJP of ``fused_layernorm``)
(control: dx without its mean(dyg * xhat) term). The plain forms of row 7's
two passes compose to the one plain backward bit for bit.

Then a depth-1 ViT-B on the tiny grid, initialised by JAX and carried by
``from_flax``, takes one train step as ``tests/test_torch_train.py`` does:
under the default switches, B ``fuse_ln_dense`` (row 14's backward at
D=768) and C ``use_fused_layernorm=False`` (row 13's); those two
backwards' plain versions are held against JAX's kernels in
``tests/test_torch_vit_base_variants_train.py``.

Last, the widths: each Python entry of a kernel accepts exactly the widths
its C++ entry instantiates (``by_width<...>`` in ``intentbev_torch/csrc``),
so no entry takes a width its kernel refuses; every entry takes 768.
"""

import dataclasses
import importlib
import inspect
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_ln_mlp_bwd as bwd_cases  # noqa: E402
import test_torch_ln_mlp_fwd as fwd_cases  # noqa: E402
import test_torch_ln_proj as ln_cases  # noqa: E402
from intentbev import configs as jcfg  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.ops.fused_ln_mlp import (  # noqa: E402
    fused_ln_mlp_bwd_dh_plain, fused_ln_mlp_bwd_plain, fused_ln_mlp_bwd_rows_plain)
from test_torch_train import _vit_switches, check_train_step  # noqa: E402

D = 768
VIT_B = dict(embed_dim=D, num_heads=12, depth=1)
# Row 7's f32 gradients at D=768: relative L2 limit. The sound readings grow
# with the width (dgamma 7.3e-6 at D=192, 2.2e-5 at 384, 7.4e-5 at 768; dW2
# 1.0e-4 at 768, where the narrow widths' file holds 1e-4): longer f32 sums
# move more dh and g values by an ulp and tip more h and dg to the other
# bf16 neighbour. The controls that move a rounding point read >= 1.66e-3.
REL = 3e-4
CSRC = Path(__file__).resolve().parents[1] / "intentbev_torch" / "csrc"


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's outputs by case: a compile of interpret-mode kernels each."""
    return {}


@pytest.mark.parametrize("gated", [True, False])
def test_row6_training_forward_matches_jax(jax_runs, monkeypatch, gated):
    """``fused_ln_mlp_train_plain`` at D=768, hidden 3072, against ``_fwd``
    (the exact erf GELU of training)."""
    want = fwd_cases._jax(jax_runs, "train", "erf", 0, D, gated, monkeypatch)
    shares = fwd_cases._shares(fwd_cases._port("train", "erf", 0, D, gated), want)
    print(f"row 6 D=768 gated={gated}: share {shares}")
    assert max(shares) <= fwd_cases.SHARE, shares


def test_row6_control_exceeds_the_limit(jax_runs, monkeypatch):
    """h kept in f32 before fc2 (ungated: the serving tail's y) moves y past
    the limit."""
    want = fwd_cases._jax(jax_runs, "train", "erf", 0, D, False, monkeypatch)
    got = fwd_cases._faulty_ln_out(0, D, "erf", "h_f32")[:1]
    assert fwd_cases._shares(got, want)[0] > fwd_cases.SHARE


@pytest.mark.parametrize("gated", [True, False])
def test_row7_backward_matches_jax(jax_runs, monkeypatch, gated):
    """``fused_ln_mlp_bwd_plain`` at D=768 against ``_bwd_kernel`` through
    the VJP of ``fused_ln_mlp``."""
    r = bwd_cases._readings(bwd_cases._port(True, 0, D, gated),
                            bwd_cases._jax(jax_runs, True, 0, D, gated, monkeypatch))
    print(f"row 7 D=768 gated={gated}: dx share {r[0]:.4%}, relative L2 {r[1:]}")
    assert r[0] <= bwd_cases.SHARE and max(r[1:]) <= REL, r


@pytest.mark.parametrize("fault,output", [("dg_f32", 0), ("h_f32", 5), ("db1_bf16", 4)])
def test_row7_controls_exceed_the_limits(jax_runs, monkeypatch, fault, output):
    """At D=768 as at 384: dg kept in f32 before dxn moves dx, h kept in f32
    moves dW2, db1 from the bf16 dg moves db1; the other outputs of each
    control stay sound."""
    want = bwd_cases._jax(jax_runs, True, 0, D, True, monkeypatch)
    r = bwd_cases._readings(bwd_cases._faulty(0, D, fault), want)
    limits = [bwd_cases.SHARE] + [REL] * 6
    assert r[output] > limits[output], r
    assert all(v <= lim for i, (v, lim) in enumerate(zip(r, limits))
               if i != output and not (fault == "dg_f32" and i in (1, 2))), r


@pytest.mark.parametrize("gated", [True, False])
def test_row7_passes_compose_to_the_backward(gated):
    """The plain forms of the D=768 kernel's two passes (dh = dy_eff W2 in
    f32; then the rows from dh) give the plain backward's outputs bit for
    bit: the split moves no rounding point."""
    x, gamma, beta, w1, b1, w2, gate, dy = bwd_cases._port_args(0, D, gated)
    want = fused_ln_mlp_bwd_plain(x, gamma, beta, w1, b1, w2, gate, dy, bwd_cases.EPS)
    dh, dye, db2 = fused_ln_mlp_bwd_dh_plain(w2, gate, dy)
    assert dh.dtype == torch.float32 and dh.shape == (bwd_cases.N, 4 * D)
    dx, dgamma, dbeta, xn, h, dg, db1 = fused_ln_mlp_bwd_rows_plain(
        x, gamma, beta, w1, b1, dh, dy, bwd_cases.EPS)
    got = (dx, dgamma, dbeta, torch.matmul(dg.float().t(), xn.float()), db1,
           torch.matmul(dye.float().t(), h.float()), db2)
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_rows8_9_layernorm_backward_matches_jax(jax_runs):
    """``layernorm_train_plain`` then ``layernorm_bwd_plain`` at D=768
    against JAX's ``_fwd_kernel`` / ``_bwd_kernel``."""
    r = ln_cases._ln_readings(ln_cases._port_ln(D), ln_cases._jax_ln(jax_runs, D))
    print(f"rows 8-9 D=768: dx share {r[0]:.4%}, relative L2 {r[1:]}")
    assert r[0] <= ln_cases.SHARE and max(r[1:]) <= ln_cases.REL, r


def test_rows8_9_control_exceeds_the_limit(jax_runs):
    """Without the mean(dyg * xhat) term dx moves past the share limit."""
    r = ln_cases._ln_readings(ln_cases._port_ln(D, no_m2=True), ln_cases._jax_ln(jax_runs, D))
    assert r[0] > ln_cases.SHARE and max(r[1:]) <= ln_cases.REL, r


@pytest.mark.parametrize("switches", ["default", "ln_dense", "unfused_ln"])
def test_vit_b_train_step_matches_jax(rng, switches):
    """A depth-1 ViT-B on the tiny grid (the packed flash attention at 12
    heads of 64) under the default switches (fused LN, fused MLP), B
    ``fuse_ln_dense`` and C ``use_fused_layernorm=False``: one train step's
    metrics and every gradient against JAX's, by
    :func:`test_torch_train.check_train_step`'s limits."""
    def step_cfg(c):
        return dataclasses.replace(
            c, vit=dataclasses.replace(_vit_switches(c.vit, switches), drop_path_rate=0.0,
                                       **VIT_B),
            augment=dataclasses.replace(c.augment, dropout_prob=1.0))

    check_train_step(rng, step_cfg(jcfg.tiny_test_config()), step_cfg(tcfg.tiny_test_config()))


# -------------------------------------------------------------- widths --

def _instances(src, entry):
    """The widths ``entry`` of ``csrc/<src>`` dispatches to (its
    ``by_width<...>`` list; the first one in an entry with two, such as
    the projection's d_in)."""
    text = (CSRC / src).read_text()
    body = text[text.index(f'extern "C" int {entry}('):]
    return tuple(sorted(int(w) for w in re.search(r"by_width<([\d, ]+)>", body)[1].split(",")))


# (the ops modules: ``intentbev_torch.ops`` re-exports functions named like
# some of them)
layernorm, fused_ln_mlp, fused_mlp, fused_ln_dense, patch_embed, voxel_embed, fused_mlp_int8 = (
    importlib.import_module(f"intentbev_torch.ops.{m}") for m in (
        "layernorm", "fused_ln_mlp", "fused_mlp", "fused_ln_dense", "patch_embed", "voxel_embed",
        "fused_mlp_int8"))
# Python entry -> (its module's width constant, C++ source, C++ entry)
ENTRIES = {
    layernorm.layernorm: ("VIT_B_WIDTHS", "layernorm.cu", "ibk_layernorm"),
    layernorm.layernorm_train: ("VIT_B_WIDTHS", "layernorm.cu", "ibk_layernorm_train"),
    layernorm.layernorm_bwd: ("VIT_B_WIDTHS", "layernorm.cu", "ibk_layernorm_bwd"),
    fused_ln_mlp.fused_ln_mlp: ("VIT_B_WIDTHS", "fused_ln_mlp.cu", "ibk_fused_ln_mlp"),
    fused_ln_mlp.fused_ln_mlp_train: ("VIT_B_WIDTHS", "fused_ln_mlp.cu",
                                      "ibk_fused_ln_mlp_train"),
    fused_ln_mlp.fused_ln_mlp_bwd: ("VIT_B_WIDTHS", "fused_ln_mlp.cu", "ibk_fused_ln_mlp_bwd"),
    fused_mlp.fused_mlp: ("VIT_B_WIDTHS", "fused_ln_mlp.cu", "ibk_fused_mlp"),
    fused_mlp.fused_mlp_train: ("VIT_B_WIDTHS", "fused_ln_mlp.cu", "ibk_fused_mlp"),
    fused_mlp.fused_mlp_bwd: ("VIT_B_WIDTHS", "fused_ln_mlp.cu", "ibk_fused_mlp_bwd"),
    fused_ln_dense.fused_ln_dense: ("VIT_B_WIDTHS", "fused_ln_dense.cu", "ibk_fused_ln_dense"),
    fused_ln_dense.fused_ln_dense_bwd: ("VIT_B_WIDTHS", "fused_ln_dense.cu",
                                        "ibk_fused_ln_dense_bwd"),
    patch_embed.patch_embed: ("VIT_B_WIDTHS", "patch_embed.cu", "ibk_patch_embed"),
    voxel_embed.voxel_embed_tokens: ("VIT_B_WIDTHS", "voxel_embed.cu", "ibk_voxel_embed"),
    fused_mlp_int8.fused_mlp_int8: ("VIT_B_WIDTHS", "fused_mlp_int8.cu",
                                    "ibk_fused_mlp_int8"),
}


def _checked_widths(fn, depth=3):
    """The width constants ``fn``'s code names (its docstring left out), or,
    where it names none, those of the module's helpers it calls, to
    ``depth`` calls down."""
    mod = inspect.getmodule(fn)
    src = inspect.getsource(fn).replace(fn.__doc__ or "\0", "")
    names = set(re.findall(r"\b([A-Z_]*WIDTHS)\b", src))
    if not names and depth > 0:
        for helper in set(re.findall(r"\b(_\w+)\(", src)):
            if inspect.isfunction(getattr(mod, helper, None)):
                names |= _checked_widths(getattr(mod, helper), depth - 1)
    return names


@pytest.mark.parametrize("fn", list(ENTRIES), ids=lambda f: f.__name__)
def test_entry_widths_are_its_kernels(fn):
    """The widths an entry accepts on CUDA are the ``by_width`` instances of
    the C++ entry it calls, and every entry takes ViT-B's 768: the training
    rows 6-9, the serving rows 1, 4, 5, 13, 14, 15 and 17, and the
    backwards of rows 13 and 14."""
    const, src, entry = ENTRIES[fn]
    mod = inspect.getmodule(fn)
    assert _checked_widths(fn) == {const}, (fn.__name__, _checked_widths(fn))
    assert entry in inspect.getsource(mod)
    assert tuple(sorted(getattr(mod, const))) == _instances(src, entry), (fn.__name__, const)
    assert 768 in getattr(mod, const), (fn.__name__, const)
