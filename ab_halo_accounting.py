"""`update_halo`'s host cost a call, tree against tree, on the card.

Runs each source tree's own `chip_smoke._halo_accounting` (phase 13d:
`update_halo` of one float32 field on the 2x2x2 virtual mesh of 128^3
blocks, 200 calls a timing, best of 3, with and without the halo
accounting, the flight recorder off and on) in a fresh process per tree,
in the order given, so that two versions are compared within one call::

    python3 ab_halo_accounting.py _archive/parent . . _archive/parent

Each tree builds its own kernels. Prints one JSON line: the card's name and
power limit, and per run the tree and its record (host us a call).
"""

import json
import os
import subprocess
import sys


def child(tree: str) -> int:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import implicitglobalgrid_tpu_torch as tg
    from implicitglobalgrid_tpu_torch.ops import cuda_build as cb

    cs._load_names()
    cb.build_kernels()
    cb.library()
    _, rec = cs._halo_accounting(tg, cb)
    print("AB_RECORD " + json.dumps(rec), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        return child(sys.argv[2])
    import torch

    if not torch.cuda.is_available():
        print("ab_halo_accounting: CUDA is not available", file=sys.stderr)
        return 2
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    runs = []
    for tree in trees:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                           capture_output=True, text=True, timeout=900)
        line = [x for x in r.stdout.splitlines() if x.startswith("AB_RECORD ")]
        if r.returncode != 0 or not line:
            print(r.stdout[-4000:] + r.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append({"tree": tree, "record": json.loads(line[-1][len("AB_RECORD "):])})
    print(json.dumps({"card": card.strip(), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
