"""Serving's numbers of several checkouts side by side on one card.

    python3 time_serving.py [--tree DIR ...] [--seed 0]

Runs chip_smoke.py's serving phase (``phase_slice``: the full-width model
behind ServingEngine(max_batch=8, channels=1) in bf16, a burst of 20
requests, five repeats on the warm engine and one more under torch.profiler
for the card's idle share) of each tree in turn, each in a fresh process
that builds that tree's kernels, and prints each tree's serving lines under
its name. Trees are given in the order to run them, e.g. an unpacked parent
under radzero_torch/build/ and this checkout as ``--tree P --tree . --tree .
--tree P``; without ``--tree``, this checkout once. Compare two versions
only within one call: the card's clocks and power limit move between calls.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent

RUN = """
import sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from radzero_torch.ops import _build
_build.build()
_build.load()
cs.phase_slice({seed}, cs.card_line())
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", help="a checkout's root, in the order to run")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    for i, tree in enumerate(args.tree or [str(REPO)]):
        root = Path(tree).resolve()
        proc = subprocess.run([sys.executable, "-c", RUN.format(seed=args.seed)], cwd=root,
                              capture_output=True, text=True, timeout=900)
        print(f"run {i + 1}, {root}: exit {proc.returncode}")
        for line in proc.stdout.splitlines():
            if line.lstrip().startswith("serving") or "requests answered" in line:
                print(f"  {line.strip()}")
        if proc.returncode != 0:
            print(proc.stderr[-3000:])
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
