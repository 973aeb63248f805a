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
                                    V=3000, timed=False, long_S=96)
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


def test_serving_and_output_phase_rehearsal():
    chain = _tiny_chain()
    serving = chip_smoke.phase_serving("cpu", chain, dtype=torch.float32,
                                       n_prompts=3, prompt_len=8,
                                       new_tokens=6)
    assert set(serving["runs"]) == {"session"} | set(
        chip_smoke.serving_runs(("a", "b", "c")))
    assert {"paged_tree", "adaptive_tree", "contiguous_linear",
            "contiguous_tree"} <= set(serving["runs"])
    assert all(n == 0 for n in serving["launches"].values())
    assert all(all(v) for v in
               serving["stream_equal_to_fixed_chain"].values())
    out = chip_smoke.phase_output("cpu", chain, n_prompts=3, prompt_len=8,
                                  new_tokens=6)
    assert set(out) == set(chip_smoke.OUTPUT_PATHS)
    assert all(r["identical_rows"] == 3 for r in out.values())
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
