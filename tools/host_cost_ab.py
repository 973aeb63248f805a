#!/usr/bin/env python3
"""Host cost of the row-kernel wrappers of this checkout against those of
another checkout, on one CUDA card.

    python3 tools/host_cost_ab.py OTHER/src [--rounds 20] [--calls 200]

``OTHER/src`` holds another commit's ``repro_torch`` (unpack it with
``git archive`` into ``build/``, which ``.gitignore`` lists).  Its package
is loaded under another name beside this one, and the two take turns:
``--rounds`` rounds, the order reversed every other round, each timing
``chip_smoke.host_cost`` (``--calls`` calls of ``ops.verify_row_stats`` at
R=20 and of ``ops.draft_topk`` at R=16, k=2, V=32000 fp32).  Prints the
median over rounds of each side's median host microseconds per call and
writes every round to ``chiprun_out/host_ab.json``.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def load_other_ops(src: Path):
    """``kernels.ops`` of the ``repro_torch`` package under ``src``,
    imported as ``other_repro_torch``."""
    init = src / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "other_repro_torch", init,
        submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(spec.name + ".kernels.ops")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_src", type=Path)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    try:
        dev = chip_smoke.phase_device()
    except chip_smoke.PhaseFailed as e:
        print(f"host_cost_ab: FAILED: {e}", file=sys.stderr)
        return 1
    sides = {"this": chip_smoke.ops,
             "other": load_other_ops(args.other_src.resolve())}
    rounds = {name: [] for name in sides}
    for rnd in range(args.rounds):
        for name in (list(sides) if rnd % 2 == 0 else list(sides)[::-1]):
            rounds[name].append(chip_smoke.host_cost(
                "cuda", calls=args.calls, m=sides[name]))
    res = {name: {op: float(np.median([r[op] for r in rs]))
                  for op in rs[0]} for name, rs in rounds.items()}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "host_ab.json").write_text(json.dumps(
        {"device": dev, "other": str(args.other_src), "us_per_call": res,
         "rounds": rounds}, indent=1))
    print(json.dumps({"host_ab": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
