#!/usr/bin/env python3
"""Host cost of the row-kernel wrappers of this checkout against those of
another checkout, or with ``--device`` the device time of the softmax
statistics and DTV kernels of both, on one CUDA card.

    python3 tools/host_cost_ab.py OTHER/src [--rounds 20] [--calls 200]
    python3 tools/host_cost_ab.py OTHER/src --device [--iters 50]

``OTHER/src`` holds another commit's ``repro_torch`` (unpack it with
``git archive`` into ``build/``, which ``.gitignore`` lists), or a copy of
this one with a variant kernel source or plan.  Its package is loaded
under another name beside this one; its kernels build from its own
sources into its own ``build/`` (the row kernels have internal linkage, so
both libraries load side by side).

Host cost: the two take turns, ``--rounds`` rounds, the order reversed
every other round, each timing ``chip_smoke.host_cost`` (``--calls``
calls of ``ops.verify_row_stats`` at R=20, ``ops.draft_topk`` at R=16,
k=2, and ``ops.dtv`` and ``ops.softmax_stats`` at R=4, V=32000 fp32).
Prints the median over rounds of each side's median host microseconds
per call and writes every round to ``chiprun_out/host_ab.json``.

Device time (``--device``): each side's ``ops.softmax_stats`` and
``ops.dtv`` on the same rows (``chip_smoke.dtv_case``) at R=1 and 4,
V=32000, 151936 and 262144, fp32 and bf16.  Each result is held against
the plain version (max exact, sumexp rtol 1e-5, DTV atol 1e-5), then both
sides are timed as ``chip_smoke`` times kernels (CUDA events, 256 MB
written before each launch to evict L2) in the order this, other, other,
this.  Prints one line per case and side and writes every case to
``chiprun_out/device_ab.json``; exits 1 if a side disagrees with the plain
version.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

CASES = [(R, V, dt) for dt in (torch.float32, torch.bfloat16)
         for R in (1, 4) for V in (32000, 151936, 262144)]


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


def host_ab(sides: dict, rounds_n: int, calls: int) -> dict:
    """Each side's host microseconds per call, round by round."""
    rounds = {name: [] for name in sides}
    for rnd in range(rounds_n):
        for name in (list(sides) if rnd % 2 == 0 else list(sides)[::-1]):
            rounds[name].append(chip_smoke.host_cost(
                "cuda", calls=calls, m=sides[name]))
    return rounds


def device_ab(sides: dict, iters: int) -> tuple:
    """Each side's softmax-statistics and DTV device ms, case by case."""
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {name: importlib.import_module(
        m.__name__.rsplit(".", 1)[0] + ".verify").row_split_plan
        for name, m in sides.items()}
    out, ok = [], True
    for R, V, dt in CASES:
        a, b = chip_smoke.dtv_case("cuda", dt, R=R, V=V)
        m0, s0 = chip_smoke.dtv.softmax_stats_plain(a)
        d0 = chip_smoke.dtv.dtv_plain(a, b)
        recs = {}
        for name, m in sides.items():
            (ms, ss), d = m.softmax_stats(a), m.dtv(a, b)
            good = (torch.equal(ms, m0)
                    and float(((ss - s0).abs() / s0).max()) <= 1e-5
                    and float((d - d0).abs().max()) <= 1e-5)
            ok = ok and good
            recs[name] = {"side": name, "R": R, "V": V,
                          "dtype": chip_smoke._dtname(dt),
                          "cluster": plans[name](R, V, a.element_size(),
                                                 n_sm)[0],
                          "agrees_with_plain": good,
                          "softmax_stats": [], "dtv": []}
        for name in ("this", "other", "other", "this"):
            m = sides[name]
            recs[name]["softmax_stats"].append(chip_smoke._time_ms(
                lambda: m.softmax_stats(a), iters, flush))
            recs[name]["dtv"].append(chip_smoke._time_ms(
                lambda: m.dtv(a, b), iters, flush))
        for rec in recs.values():
            for k in ("softmax_stats", "dtv"):
                rec[k] = sum(rec[k]) / len(rec[k])
            out.append(rec)
            print(f"[device_ab] {rec['side']:5s} R={R} V={V} {rec['dtype']}: "
                  f"C={rec['cluster']} softmax_stats "
                  f"{rec['softmax_stats']:.4f} ms, dtv {rec['dtv']:.4f} ms, "
                  f"agrees={rec['agrees_with_plain']}")
    return out, ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_src", type=Path)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--device", action="store_true")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    try:
        dev = chip_smoke.phase_device()
    except chip_smoke.PhaseFailed as e:
        print(f"host_cost_ab: FAILED: {e}", file=sys.stderr)
        return 1
    sides = {"this": chip_smoke.ops,
             "other": load_other_ops(args.other_src.resolve())}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    if args.device:
        cases, ok = device_ab(sides, args.iters)
        (out_dir / "device_ab.json").write_text(json.dumps(
            {"device": dev, "other": str(args.other_src), "cases": cases},
            indent=1))
        return 0 if ok else 1
    rounds = host_ab(sides, args.rounds, args.calls)
    res = {name: {op: float(np.median([r[op] for r in rs]))
                  for op in rs[0]} for name, rs in rounds.items()}
    (out_dir / "host_ab.json").write_text(json.dumps(
        {"device": dev, "other": str(args.other_src), "us_per_call": res,
         "rounds": rounds}, indent=1))
    print(json.dumps({"host_ab": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
