"""Offline intention-label precompute CLI (a copy of
``intentbev/precompute_labels.py``; host only, no device work).

Equivalent of reference ``preprocess_intent_labels.py`` (its broken
``namedtuple`` import fixed by construction): per log, read
``annotations.feather``, label every vehicle row with the trajectory
heuristic (+ map context from the log's map JSON), write
``annotations_with_intent.feather``; skip-if-exists unless ``--force``.

The per-row O(rows^2) track re-filtering of the reference
(heuristic_labeling.py:31) is replaced by one vectorised pass per track
(``labeling.heuristic``).

Usage:
    python -m intentbev_torch.precompute_labels --data_root /path/to/argoverse2/sensor \
        --splits train val [--force] [--no-map]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from .configs import HeuristicConfig
from .data.argoverse import ScenarioPaths, ScenarioValidator
from .labeling.heuristic import MapContext, label_log_annotations
from .bev.rasterize import parse_map_json


def preprocess_scenario(
    info: ScenarioPaths,
    cfg: HeuristicConfig,
    force: bool = False,
    use_map: bool = True,
) -> str:
    """Label one log. Returns 'skipped' | 'ok' | 'failed'."""
    from .utils.featherio import read_ipc_dataframe, write_ipc_dataframe

    log_dir = Path(info.log_dir)
    out_path = log_dir / "annotations_with_intent.feather"
    if out_path.is_file() and not force:
        return "skipped"
    try:
        df = read_ipc_dataframe(info.annotations_path)
        map_ctx = None
        if use_map:
            try:
                map_ctx = MapContext(parse_map_json(info.map_path))
            except Exception as e:  # noqa: BLE001 — degrade to kinematics-only
                print(f"  map parse failed for {log_dir.name}: {e}; "
                      "labeling without map context")
        labelled = label_log_annotations(df, cfg, map_ctx)
        write_ipc_dataframe(labelled, out_path)
        return "ok"
    except Exception as e:  # noqa: BLE001
        print(f"  FAILED {log_dir.name}: {e}")
        return "failed"


def run(data_root: str, splits: list[str], force: bool = False, use_map: bool = True,
        cfg: HeuristicConfig | None = None) -> dict:
    cfg = cfg or HeuristicConfig()
    totals = {"ok": 0, "skipped": 0, "failed": 0}
    for split in splits:
        split_dir = Path(data_root) / split
        print(f"--- split {split}: {split_dir}")
        scenarios = ScenarioValidator(str(split_dir)).find_valid_scenarios()
        t0 = time.time()
        for i, info in enumerate(scenarios):
            status = preprocess_scenario(info, cfg, force=force, use_map=use_map)
            totals[status] += 1
            if (i + 1) % 25 == 0:
                print(f"  {i + 1}/{len(scenarios)} logs "
                      f"({time.time() - t0:.1f}s elapsed)")
        print(f"  split {split} done in {time.time() - t0:.1f}s: {totals}")
    return totals


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_root", required=True)
    p.add_argument("--splits", nargs="+", default=["train", "val"])
    p.add_argument("--force", action="store_true")
    p.add_argument("--no-map", dest="use_map", action="store_false")
    args = p.parse_args(argv)
    totals = run(args.data_root, args.splits, force=args.force, use_map=args.use_map)
    print(f"Done: {totals}")


if __name__ == "__main__":
    main()
