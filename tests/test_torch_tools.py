"""The port's example and tool twins against the JAX package's, on the CPU.

- ``examples/make_synthetic_dataset_torch.py`` and the JAX script, at one
  train and one val log of 5 frames under ``--hard`` (occlusion, clutter,
  label noise), write the same files: the map JSON byte for byte, every
  feather table column by column (``track_uuid`` by its pattern of repeats:
  both writers draw it from ``uuid.uuid4()``), so the same labels;
- ``tools/soak_loader_torch.py`` and ``tools/soak_loader.py``, each
  generating one log of 10 frames, print one JSON line with the same keys
  in the same order and the same counts;
- ``tools/score_range_torch.py`` and ``tools/score_range.py`` on one tiny
  ViT checkpoint (a JAX init, saved by each package's ``checkpoint.py``,
  the port's through ``from_flax``) and one batch of the synthetic split
  print the same lines (the JAX tool prints text, no JSON): as many
  attention calls; the extrema of each stream's first block, whose q and k
  precede any attention, within 0.03 + 1 % (sound: 0.02 at scores of 2-3.6,
  the qkv weights scaled by 8 so that the scores are not the init's ~0.05);
  the later blocks' within 0.1 + 5 % (sound: 0.12 at 2.2): JAX's probe
  returns its own f32 softmax where the port's plain path rounds P to bf16
  as the model does, so their later q and k part;
- ``examples/serve_chunks_torch.py`` prints the JAX example's three rates
  and its last line at the tiny config;
- ``bench_torch.py`` refuses ``INTENTBEV_CNN_FILL_LAYOUT=barrier`` and runs
  its CNN chunk line with the f32 fill;
- ``tools/smoke_phases_torch.py`` stamps each of ``chip_smoke.py``'s 17
  phases, and on a toy smoke gives each phase's seconds and the exit code.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import re
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from intentbev import configs as jcfg  # noqa: E402
from intentbev.checkpoint import save_checkpoint as jsave  # noqa: E402
from intentbev.models import build_model as jbuild_model  # noqa: E402
from intentbev.utils.featherio import read_ipc_dataframe  # noqa: E402
from intentbev_torch import configs as tcfg  # noqa: E402
from intentbev_torch.checkpoint import save_checkpoint as tsave  # noqa: E402
from intentbev_torch.weights import from_flax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _module(rel: str):
    """A script of the repo as a module (its own name, loaded once)."""
    name = "twin_" + rel.replace("/", "_").removesuffix(".py")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, ROOT / rel)
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def _quiet(fn, *args, **kw) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    return out.getvalue()


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Both synthetic-dataset scripts at 1 + 1 logs of 5 frames, --hard."""
    root = tmp_path_factory.mktemp("synth")
    flags = ["--train_logs", "1", "--val_logs", "1", "--frames", "5", "--points", "1500",
             "--seed", "3", "--hard"]
    _quiet(_module("examples/make_synthetic_dataset.py").main, ["--out", str(root / "jax")]
           + flags)
    _quiet(_module("examples/make_synthetic_dataset_torch.py").main,
           ["--out", str(root / "port")] + flags)
    return root / "jax", root / "port"


def test_synthetic_twin_writes_the_same_files(synth):
    jroot, troot = synth
    names = sorted(p.relative_to(jroot) for p in jroot.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(troot) for p in troot.rglob("*") if p.is_file())
    assert len(names) == 2 * (4 + 5)  # map, poses, annotations, labels, 5 sweeps a log
    labels = 0
    for name in names:
        a, b = jroot / name, troot / name
        if name.suffix == ".json":
            assert a.read_bytes() == b.read_bytes(), name
            continue
        da, db = read_ipc_dataframe(a), read_ipc_dataframe(b)
        assert list(da.columns) == list(db.columns), name
        for col in da.columns:
            if col == "track_uuid":  # uuid4 draws: the same pattern of repeats
                np.testing.assert_array_equal(pd.factorize(da[col])[0],
                                              pd.factorize(db[col])[0], err_msg=str(name))
                continue
            np.testing.assert_array_equal(da[col].to_numpy(), db[col].to_numpy(),
                                          err_msg=f"{name}:{col}")
        if "heuristic_intent" in da.columns:
            labels += int((da["heuristic_intent"] >= 0).sum())
    assert labels > 20


def test_soak_loader_twin_prints_the_jax_line(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    flags = ["--logs", "1", "--frames", "10", "--points", "1500", "--samples", "4",
             "--workers", "1", "--batch", "2"]
    monkeypatch.setattr(sys, "argv", ["soak_loader.py"] + flags)
    lines = {"jax": _quiet(_module("tools/soak_loader.py").main),
             "port": _quiet(_module("tools/soak_loader_torch.py").main, flags)}
    want, got = (json.loads(lines[k].strip().splitlines()[-1]) for k in ("jax", "port"))
    assert list(got) == list(want)
    for key in ("metric", "unit", "samples", "logs", "workers", "transport"):
        assert got[key] == want[key], key
    assert got["samples"] == 4 and got["value"] > 0 and got["rss_peak_mb"] >= got["rss_start_mb"]


CALL_LINE = re.compile(r"^  attention call +(\d+): score range \[([+-][\d.]+), ([+-][\d.]+)\]$")


def _score_lines(text):
    calls = [CALL_LINE.match(s) for s in text.splitlines() if s.startswith("  attention call")]
    assert calls and all(calls), text
    tail = [s for s in text.splitlines() if s.startswith(("global score range",
                                                           "fixed-max softmax margin"))]
    return [(float(m[2]), float(m[3])) for m in calls], tail


def test_score_range_twin_matches_jax(synth, tmp_path, monkeypatch):
    jc, tc = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    g = jc.grid
    model = jbuild_model(jc)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.key(0), np.zeros((1, g.height_px, g.width_px, g.lidar_total_channels),
                                    np.float32),
        np.zeros((1, g.height_px, g.width_px, g.map_channels), np.float32)))
    for stream in ("vit_lidar", "vit_map"):  # scores of a few units, not the init's ~0.05
        for i in range(jc.vit.depth):
            qkv = variables["params"]["backbone"][stream][f"block{i}"]["attn"]["qkv"]
            qkv["kernel"] = qkv["kernel"] * 8.0
    jsave(tmp_path / "jax", 1, dict(variables), jc)
    tsave(tmp_path / "port", 1, {"model": from_flax(variables)}, tc)
    split = synth[0] / "train"
    # the JAX tool swaps its probe into these attributes and leaves it there;
    # monkeypatch puts the originals back after the test
    import intentbev.ops as jops
    from intentbev.models import vit as jvit
    from intentbev.ops import flash_packed as jfp

    for mod, name in ((jfp, "flash_attention_packed"), (jops, "multi_head_attention"),
                      (jvit, "multi_head_attention")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(sys, "argv", ["score_range.py", "--ckpt_dir", str(tmp_path / "jax"),
                                      "--data_dir", str(split), "--batch", "1"])
    jtext = _quiet(_module("tools/score_range.py").main)
    monkeypatch.setattr(sys, "argv", ["score_range_torch.py", "--ckpt_dir",
                                      str(tmp_path / "port"), "--data_dir", str(split),
                                      "--device", "cpu", "--batch", "1"])
    ttext = _quiet(_module("tools/score_range_torch.py").main)
    (jcalls, jtail), (tcalls, ttail) = _score_lines(jtext), _score_lines(ttext)
    assert len(tcalls) == len(jcalls) == 2 * jc.vit.depth
    first = {0, jc.vit.depth}  # each stream's first block: its q and k precede any attention
    for i, (got, want) in enumerate(zip(tcalls, jcalls)):
        atol, rtol = (0.03, 0.01) if i in first else (0.1, 0.05)
        assert all(abs(a - b) <= atol + rtol * abs(b) for a, b in zip(got, want)), (i, got, want)
    assert max(abs(x) for c in jcalls for x in c) > 2.0
    assert [s.split(":")[0] for s in ttail] == [s.split(":")[0] for s in jtail]
    assert ttail[1].endswith("SAFE for FWD_UNSAFE_SOFTMAX")


def test_serve_chunks_twin_prints_the_three_rates():
    text = _quiet(_module("examples/serve_chunks_torch.py").main,
                  ["--tiny", "--device", "cpu", "--batch", "2", "--batches", "2", "--iters", "1",
                   "--points_per_sweep", "400"])
    lines = text.strip().splitlines()
    prefixes = ("host chunk build:", "device inference:", "sustained pipeline:", "last batch:")
    assert [s.split(":")[0] + ":" for s in lines] == list(prefixes)
    rates = [float(re.search(r"([\d.]+) (?:samples|frames)/s", s)[1]) for s in lines[:3]]
    assert all(np.isfinite(r) and r > 0 for r in rates), rates


def test_bench_torch_cnn_fill_layout(monkeypatch):
    bench_torch = _module("bench_torch.py")
    monkeypatch.setattr(sys, "argv", ["bench_torch.py", "--model", "cnn", "--cnn_chunks"])
    monkeypatch.setenv("INTENTBEV_CNN_FILL_LAYOUT", "barrier")
    with pytest.raises(SystemExit, match="XLA-only"):
        bench_torch.main()
    cfg = dataclasses.replace(tcfg.tiny_test_config(), model_family="cnn")
    out = _quiet(bench_torch.run_mode, "bev_frames_per_sec_per_chip_cnn_chunks", "cnn",
                 batch_size=2, points_per_sweep=300, voxembed=True, iters=1, device="cpu",
                 cfg=cfg, fill_dtype=torch.float32)
    d = json.loads(out)
    assert d["metric"] == "bev_frames_per_sec_per_chip_cnn_chunks" and d["value"] > 0


TOY_SMOKE = """import sys
import time


def main():
    # 1. first
    time.sleep(0.2)
    # 2. second
    # its comment goes on
    time.sleep(0.4)
    if len(sys.argv) > 5:
        # 3. not a phase: deeper than main's body
        pass
    sys.exit(3)


if __name__ == "__main__":
    main()
"""


def test_smoke_phases_stamps_every_phase(tmp_path):
    """Each phase header of the repo's smoke gets one stamp and the stamped
    source compiles; a toy smoke's phases read their sleeps, its exit code
    passes through, and its last phase runs to the end of ``main()``."""
    import subprocess

    tool = _module("tools/smoke_phases_torch.py")
    stamped = tool.stamped_source((ROOT / "chip_smoke.py").read_text())
    compile(stamped, "chip_smoke.py", "exec")
    assert re.findall(r"_phase_stamp\('(\w+)'\)", stamped) == [str(n) for n in range(1, 18)]

    (tmp_path / "chip_smoke.py").write_text(TOY_SMOKE)
    run = subprocess.run([sys.executable, str(ROOT / "tools" / "smoke_phases_torch.py"),
                          str(tmp_path / "chip_smoke.py")], capture_output=True, text=True,
                         timeout=60)
    assert run.returncode == 3, run.stderr
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["rc"] == 3 and list(line["phases"]) == ["1", "2"]
    assert 0.2 <= line["phases"]["1"] < 0.4 and 0.4 <= line["phases"]["2"] < 0.6
    assert line["seconds"] >= sum(line["phases"].values()) - 0.01  # each rounded to 0.01
