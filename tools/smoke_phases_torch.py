"""Seconds per phase of a ``chip_smoke.py``, on one CUDA card.

Runs the smoke at PATH (default the repo's) in this process with a stamp
after each phase header of its ``main()`` (a comment ``# N. ...`` at the
body's indent), so that any version of the smoke, an older commit's too,
can be timed the same way. The smoke's own output is passed through; after
it, one JSON line gives each phase's seconds, from its header to the next
one's (the last phase's to the end of ``main()``), and the smoke's exit
code:

    python3 tools/smoke_phases_torch.py                   # ./chip_smoke.py
    python3 tools/smoke_phases_torch.py OTHER/chip_smoke.py

The smoke's child processes run the file at PATH as it is. It imports no
JAX.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from pathlib import Path

HEADER = re.compile(r"^    # (\d+[a-z]?)\. ")


def stamped_source(text: str) -> str:
    """The smoke's source with ``_phase_stamp("N")`` after each phase header."""
    out = []
    for line in text.splitlines(keepends=True):
        out.append(line)
        found = HEADER.match(line)
        if found:
            out.append(f"    _phase_stamp({found[1]!r})\n")
    return "".join(out)


def phase_seconds(stamps: list[tuple[str, float]], end: float) -> dict[str, float]:
    """Seconds from each stamp to the next (the last to ``end``)."""
    ends = [t for _, t in stamps[1:]] + [end]
    return {name: round(e - t, 2) for (name, t), e in zip(stamps, ends)}


def main() -> None:
    path = Path(sys.argv[1] if len(sys.argv) > 1 else "chip_smoke.py").resolve()
    stamps: list[tuple[str, float]] = []
    code = compile(stamped_source(path.read_text()), str(path), "exec")
    sys.argv = [str(path)]
    sys.path.insert(0, str(path.parent))
    os.chdir(path.parent)
    rc, t0 = 1, time.perf_counter()
    try:
        exec(code, {"__name__": "__main__", "__file__": str(path),
                    "_phase_stamp": lambda name: stamps.append((name, time.perf_counter()))})
        rc = 0
    except SystemExit as exc:
        rc = exc.code if isinstance(exc.code, int) else (0 if exc.code is None else 1)
    finally:  # an exception of the smoke's propagates after this line
        end = time.perf_counter()
        print(json.dumps({"smoke": str(path), "rc": rc, "seconds": round(end - t0, 2),
                          "phases": phase_seconds(stamps, end)}), flush=True)
    sys.exit(rc)


if __name__ == "__main__":
    main()
