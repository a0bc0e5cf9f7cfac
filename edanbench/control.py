"""Read the comparison's two ends for a cell on the card: the program's
numbers (the lower reading) and the control's (the upper), seed by seed,
in one process.

    python3 edanbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 5]

Per seed: one run of the cell (``harness.run_cell``) with a short window
at the cell's own load, its answers compared with the reference
(``program``), and the float32 reference put in the program's place at the
same sample (``control``).  One JSON line per seed.  The benchmark's own
runs do not run this.
"""
import argparse
import json
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT / "src"), str(_ROOT)]

from edanbench import harness  # noqa: E402


def readings(cell: str, seed: int, seconds: float, root: Path = _ROOT,
             device: str = "cuda") -> dict:
    out = harness.run_cell(cell, seed, seconds, False, root=root,
                           device=device, control=True)
    return {"cell": cell, "seed": seed,
            "program": {k: v["value"] for k, v in out["checks"].items()},
            "control": out["control"], "limits": harness.LIMITS}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args()
    for s in a.seeds.split(","):
        print(json.dumps(readings(a.workload, int(s), a.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
