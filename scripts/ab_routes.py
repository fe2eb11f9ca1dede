"""Time two checkouts of the port on one card in turns: a parent commit's
tree (``git archive`` of it unpacked into a directory that ``.gitignore``
lists, such as ``build/parent_tree``) and this checkout.

    git archive HEAD | tar -x -C build/parent_tree
    python3 scripts/ab_routes.py build/parent_tree [ROUTE ...]

Runs ``utils/profile_routes.py`` of this checkout (copied into the parent's
tree first, so that both trees are measured the same way) on the ROUTEs
(default: ``default fused_gate runtime_scaling``), one process a run, in the
turns parent, change, change, parent, and prints every run's route lines,
then a summary a route: the unprofiled wall per sim batch and the
``cudaLaunchKernel`` calls per op of each run. Each tree builds its own
kernels in its first run; every timed batch follows a warm-up batch. Needs a
card.
"""

from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOL = pathlib.PurePosixPath("qml_cutensornet_tpu_torch/utils/profile_routes.py")
LINE = re.compile(r"^\[(\w+)\].*unprofiled wall per batch ([\d.]+) / ([\d.]+) s.*"
                  r"cudaLaunchKernel calls (\d+) \(([\d.]+) per op\)")


def run(tree: pathlib.Path, routes: list[str]) -> dict:
    out = subprocess.run([sys.executable, "-m", "qml_cutensornet_tpu_torch.utils.profile_routes",
                          *routes], cwd=tree, capture_output=True, text=True, check=False)
    print(out.stdout, end="", flush=True)
    if out.returncode:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"ab_routes: profile_routes failed in {tree} ({out.returncode})")
    found = {}
    for line in out.stdout.splitlines():
        m = LINE.match(line)
        if m:
            found[m[1]] = (float(m[2]), float(m[3]), int(m[4]), float(m[5]))
    return found


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    parent = pathlib.Path(args[0]).resolve()
    routes = args[1:] or ["default", "fused_gate", "runtime_scaling"]
    shutil.copyfile(ROOT / TOOL, parent / TOOL)
    turns = [("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)]
    results = []
    for name, tree in turns:
        print(f"=== {name}: {tree}", flush=True)
        results.append((name, run(tree, routes)))
    print("summary: route, run, unprofiled wall per batch s (two batches), "
          "cudaLaunchKernel calls (per op)")
    for route in routes:
        for i, (name, found) in enumerate(results):
            w1, w2, calls, per_op = found[route]
            print(f"  {route}, {i + 1} {name}: {w1:.4f} / {w2:.4f} s, {calls} ({per_op:.1f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
