"""Rehearsal of ``chip_smoke.py`` on the CPU: its phase functions run at a
tiny size with ``device="cpu"`` (plain kernel versions, no launches), and
the script itself refuses to run without a card or without the rest of
the repository."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.models import ModelConfig

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

torch.set_num_threads(2)


def _tiny_chain():
    return [ModelConfig(name=n, arch_type="dense", num_layers=L, d_model=d,
                        num_heads=4, num_kv_heads=2, d_ff=2 * d,
                        vocab_size=97, dtype=torch.float32)
            for n, L, d in (("tiny-a", 1, 32), ("tiny-b", 2, 48),
                            ("tiny-c", 2, 64))]


def test_kernel_phase_rehearsal():
    ops.reset_launch_counts()
    recs = chip_smoke.phase_kernels("cpu", attn_shapes={"tiny": (4, 2, 16)},
                                    V=3000, timed=False, long_S=96,
                                    long_V=(6000, 8192))
    assert {r["name"] for r in recs} == set(chip_smoke.REPRESENTATIVE)
    assert all(r["pass"] and r["ms"] is None for r in recs)
    attn = [r for r in recs if "attention" in r["name"]]
    assert all(r["zero_row"] and r["bitwise_repeat"] and r["splits"] >= 1
               for r in attn)
    assert sum("t1_equals_last_row" in r for r in attn) == 2
    assert all(n == 0 for n in ops.launch_counts().values())
    cases = {(r["name"], r["case"]) for r in recs}
    for case in ("tiny T=10 tree float32", "tiny T=10 tree S=256 float32",
                 "tiny T=5 S=256 float32", "tiny T=5 R=3x32 float32",
                 "tiny T=5 S=96 float32", "tiny T=1 R=3x32 bfloat16",
                 "tiny T=1 S=96 bfloat16"):
        assert any(c == case for _, c in cases), case
    for k in (1, 2):
        for R in (4, 8, 16):
            assert ("draft_topk", f"R={R} V=3000 k={k} bfloat16") in cases
    rows = [r for r in recs if r["name"] in ("verify_stats", "draft_topk")]
    assert all(r["bitwise_repeat"] and r["cluster"] in (1, 2, 4, 8)
               and r["ctas"] >= r["cluster"] for r in rows)
    for dt in ("float32", "bfloat16"):
        for V in (3000, 3001, 6000, 8192):
            assert ("verify_stats", f"R=20 V={V} {dt}") in cases
        assert ("verify_stats", f"B=4 T+1=5 view V=3000 {dt}") in cases
        assert ("verify_stats", f"R=44 tree V=3000 {dt}") in cases
        for R, V, k in ((16, 3000, 8), (16, 3001, 2), (16, 6000, 2),
                        (16, 8192, 2)):
            assert ("draft_topk", f"R={R} V={V} k={k} {dt}") in cases
        for name in ("softmax_stats", "dtv"):
            for R in (1, 4):
                for V in (3000, 3001, 6000, 8192):
                    assert (name, f"R={R} V={V} {dt}") in cases
            assert (name, f"R=4 V=3000 row stride 3001 {dt}") in cases
    pairs = [r for r in recs if r["name"] in ("softmax_stats", "dtv")]
    assert len(pairs) == 36
    assert all(r["bitwise_repeat"] and r["cluster"] in (1, 2, 4, 8)
               for r in pairs)


def test_kernels_line_counts_the_softmax_pass_inside_dtv_launches(
        monkeypatch):
    """Off the card the line carries no times, but every key of it; the
    softmax statistics' ``in_dtv_launches`` are the ``dtv`` launches, and
    only they keep its kernel off the never-launched list.  The rehearsal
    runs the representative cases at V=3000 with tiny attention heads."""
    monkeypatch.setattr(chip_smoke, "REPRESENTATIVE", {
        k: c.replace("V=32000", "V=3000")
        for k, c in chip_smoke.REPRESENTATIVE.items()})
    recs = chip_smoke.phase_kernels(
        "cpu", attn_shapes={"llama-2-7b": (4, 2, 16)}, V=3000, timed=False,
        long_S=96, long_V=(6000,))
    launches = {k: 3 for k in ops.launch_counts()}
    launches.update(softmax_stats=0, dtv=5)
    line = chip_smoke.kernels_line(recs, launches)
    assert [e["name"] for e in line] == list(chip_smoke.REPRESENTATIVE)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(e) for e in line)
    assert all(e["route"] == "cuda" for e in line)
    stats = next(e for e in line if e["name"] == "softmax_stats")
    assert stats["launches"] == 0 and stats["in_dtv_launches"] == 5
    assert chip_smoke.never_launched(launches) == []
    assert chip_smoke.never_launched({**launches, "dtv": 0}) == [
        "softmax_stats", "dtv"]
    assert chip_smoke.never_launched({**launches, "draft_topk": 0}) == [
        "draft_topk"]


def test_floor_and_host_cost_rehearsal():
    """Off the card the floor has nothing to time; the host-cost line
    times the plain versions behind the same ``ops`` calls, for this
    checkout's ``ops`` and for a second copy of the package loaded under
    another name the way ``tools/host_cost_ab.py`` loads another
    checkout's."""
    assert chip_smoke.kernel_floor("cpu") == {"flushed_ms": None,
                                              "unflushed_ms": None}
    sys.path.insert(0, str(ROOT / "tools"))
    import host_cost_ab
    other = host_cost_ab.load_other_ops(ROOT / "src")
    assert other is not ops and other.__name__.startswith("other_")
    for m in (ops, other):
        host = chip_smoke.host_cost("cpu", V=3000, calls=4, m=m)
        assert set(host) == {"verify_row_stats", "draft_topk", "dtv",
                             "softmax_stats"}
        assert all(v > 0 for v in host.values())


def test_serving_and_output_phase_rehearsal():
    chain = _tiny_chain()
    serving = chip_smoke.phase_serving("cpu", chain, dtype=torch.float32,
                                       n_prompts=3, prompt_len=8,
                                       new_tokens=6)
    per_op = {f"{label}_per_op" for label in chip_smoke.PER_OP_TWINS}
    assert set(serving["runs"]) == {"session"} | per_op | set(
        chip_smoke.serving_runs(("a", "b", "c")))
    assert {"paged_tree", "adaptive_tree", "contiguous_linear",
            "contiguous_tree"} <= set(serving["runs"])
    assert all(n == 0 for n in serving["launches"].values())
    assert all(all(v) for v in
               serving["stream_equal_to_fixed_chain"].values())
    for label, rec in serving["runs"].items():
        if label == "session":
            continue
        fused = rec["fused"]
        if label in per_op:
            assert fused["groups_fused"] == 0
            assert fused["host_syncs_per_cycle"] > 1.0
        else:
            assert fused["groups_fused"] > 0
        assert fused["graph_captures"] == 0          # no graphs off the card
    assert serving["sync_debug"] == {
        label: {"host_syncs": 1, "fused_groups": 1, "sync_debug_mode": None}
        for label in chip_smoke.PER_OP_TWINS}
    out = chip_smoke.phase_output("cpu", chain, n_prompts=3, prompt_len=8,
                                  new_tokens=6)
    assert set(out) == set(chip_smoke.OUTPUT_PATHS) | {
        f"{p}_per_op" for p in chip_smoke.OUTPUT_PATHS}
    assert all(r["identical_rows"] == 3 for r in out.values())
    assert all(out[p]["identical_rows_fused_vs_per_op"] == 3
               for p in chip_smoke.OUTPUT_PATHS)
    session = out["twin_contiguous_session"]
    assert session["defragments"] > 0
    assert min(session["commits_per_active_cycle"]) > 1.0
    cycles = out["twin_paged_tree"]["cycles"]
    assert cycles["speculative"] < cycles["target_only"]


def _run(script_dir):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=script_dir,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_script_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the script would run for real")
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
