#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py        # needs one CUDA card; ~2.5 minutes

Phases, each printing its own lines:

1. device  — the card's name and power limit (``nvidia-smi``); no card,
             no run (exit 1).
2. build   — compile the CUDA kernel with nvcc and the Triton kernels.
3. kernels — every kernel against its plain PyTorch version at the main
             path's shapes, fp32 and bf16, with CUDA-event times, the
             plain version's time, the roofline bound and, for attention,
             ``F.scaled_dot_product_attention`` on a gathered contiguous
             K/V as the library yardstick (timed only; the port never
             calls it).  ``dtv`` is timed as the wrapper the probe calls:
             two softmax-stats launches and one |p - q| launch.
4. serving — the full-width Llama chain llama-68m -> tinyllama-1.1b ->
             llama-2-7b in bf16 with random weights: adaptive ``generate``,
             fixed-chain ``generate`` (window 4) and a ``RouterSession``
             with a mid-flight admission.  Launch counters are zeroed just
             before and read just after; every kernel must have launched.
             One more fixed-chain ``generate`` then runs under
             ``torch.profiler`` (not counted in the launches): its device
             time by kernel class and the device busy share are the
             source of PERF.md's "Where the time goes".
5. output  — the same chain in fp32 (TF32 off): speculative greedy output
             must equal target-only greedy output, or diverge only where
             the target's top-2 logit gap is below 1e-3.

The second-to-last line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  A failed phase exits non-zero before
either is printed.  The full case table is written to
``chiprun_out/chip_smoke.json``.

Every phase is a function of a device and a configuration, so the CPU
tests rehearse them at a tiny size with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import attention, build, dtv, ops, verify  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
PEAK_OPS = {torch.float32: 67e12,  # fp32 outside the tensor cores
            torch.bfloat16: 989e12}
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
REPLACES = {
    "paged_attention": "src/repro/kernels/attention.py:207",
    "verify_stats": "src/repro/kernels/verify.py:66",
    "softmax_stats": "src/repro/kernels/dtv.py:56",
    "dtv": "src/repro/kernels/dtv.py:89",
}
ROUTES = {"paged_attention": ("cuda", attention.SOURCE),
          "verify_stats": ("triton", verify.SOURCE),
          "softmax_stats": ("triton", dtv.SOURCE),
          "dtv": ("triton", dtv.SOURCE)}


class PhaseFailed(RuntimeError):
    pass


def _dtname(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------
def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise PhaseFailed("no CUDA device: chip_smoke.py runs on one card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[device] nvidia-smi: {smi_line}")
    print(f"[device] torch: {name}, {torch.cuda.device_count()} visible, "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    return {"name": name, "smi": smi_line,
            "count": torch.cuda.device_count()}


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------
def phase_build(device) -> float:
    """nvcc the CUDA source and JIT the Triton kernels with one tiny launch
    each (launch counters are zeroed before the serving phase)."""
    t0 = time.perf_counter()
    attention._launcher()
    x = torch.randn(2, 4096, device=device)
    verify.verify_stats_triton(x, torch.zeros(2, dtype=torch.int32,
                                              device=device))
    dtv.dtv_triton(x, x)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"[build] kernels built in {secs:.1f} s")
    for src, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")
    return secs


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------
ATTN_SHAPES = {"llama-2-7b": (32, 32, 128), "tinyllama-1.1b": (32, 4, 64)}


def attention_case(device, H, Hkv, D, T, dtype, B=4, bs=32, R=8, seed=0):
    """Main-path shaped operands: per-row block tables with unallocated
    (-1) entries, causal verify-block masks, and one fully masked row
    (an inactive slot)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    P = B * R + 8
    lens = [min(200, R * bs), 131, 77, 0][:B] + [64] * max(0, B - 4)
    table = torch.full((B, R), -1, dtype=torch.int32)
    perm = torch.randperm(P, generator=g)
    used = 0
    mask = torch.zeros(B, T, R * bs, dtype=torch.bool)
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        table[b, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb
        for t in range(T):
            mask[b, t, :max(n - T + 1 + t, 0)] = n > 0
    q = torch.randn(B, T, H, D, generator=g)
    k = torch.randn(P * bs, Hkv, D, generator=g)
    v = torch.randn(P * bs, Hkv, D, generator=g)
    to = dict(device=device)
    return (q.to(dtype=dtype, **to), k.to(dtype=dtype, **to),
            v.to(dtype=dtype, **to), table.to(**to), mask.to(**to), bs)


def verify_case(device, dtype, R=20, V=32000, seed=1):
    """Logits rows with planted argmax ties inside one tile, across tiles
    and at the vocabulary's ends; half the candidates are the argmax."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(R, V, generator=g) * 3.0
    ties = [(5, 6), (100, 2100), (0, V - 1), (2047, 2048), (17, V - 2000)]
    for r, (a, b) in enumerate(ties[:R]):
        top = x[r].max() + 1.0
        x[r, a] = top
        x[r, b] = top
    x = x.to(dtype)
    cand = torch.randint(0, V, (R,), generator=g, dtype=torch.int32)
    am = x.float().argmax(dim=-1).to(torch.int32)
    cand[::2] = am[::2]
    return x.to(device), cand.to(device)


def dtv_case(device, dtype, R=4, V=32000, seed=2):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(R, V, generator=g) * 2.0
    b = a + 0.5 * torch.randn(R, V, generator=g)
    return a.to(device=device, dtype=dtype), b.to(device=device, dtype=dtype)


def _time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` from CUDA events, L2 evicted before
    each launch (main-path callers find these operands cold).  A leading
    device sleep lets the host enqueue every launch before the device
    reaches them, so host overhead stays out of the events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for e0, e1 in ev:
        flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in ev]))


def _attn_bound(q, k, table, mask, bs) -> tuple:
    B, T, H, D = q.shape
    Hkv = k.shape[1]
    elt = q.element_size()
    # K and V of the keys that some query of the row attends to
    kv_bytes = int(mask.any(dim=1).sum()) * Hkv * D * elt * 2
    nbytes = (2 * q.numel() * elt + kv_bytes + table.numel() * 4
              + mask.numel())
    ops_count = 4 * H * D * int(mask.sum())
    return _bound(nbytes, ops_count, PEAK_OPS[q.dtype])


def _bound(nbytes: float, ops_count: float, peak: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_call(q, k, v, table, mask, bs):
    """F.scaled_dot_product_attention on the same function's inputs,
    gathered into contiguous per-row K/V (gather outside the timing)."""
    B, T, H, D = q.shape
    Hkv = k.shape[1]
    S = table.shape[1] * bs
    s = torch.arange(S, device=q.device)
    flat = table[:, s // bs].long().clamp(min=0) * bs + (s % bs)[None, :]
    kk = k[flat].permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1)
    vv = v[flat].permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1)
    qq = q.permute(0, 2, 1, 3).contiguous()
    kk, vv = kk.contiguous(), vv.contiguous()
    am = mask[:, None].contiguous()
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=am)


def phase_kernels(device, dtypes=(torch.float32, torch.bfloat16),
                  attn_shapes=None, Ts=(1, 5), V=32000, iters=50,
                  timed=True) -> list:
    """Every kernel (through its ``ops`` wrapper) against its plain
    version.  Returns one record per case; raises PhaseFailed when a case
    is outside its tolerance.  ``timed=False`` (the CPU rehearsal) skips
    the device timings."""
    attn_shapes = attn_shapes or ATTN_SHAPES
    flush = (torch.empty(256 << 20, dtype=torch.int8, device=device)
             if timed else None)
    records = []

    def add(rec, fn_kernel, fn_plain, fn_lib):
        if timed:
            rec["ms"] = _time_ms(fn_kernel, iters, flush)
            rec["plain_ms"] = _time_ms(fn_plain, max(iters // 5, 5), flush)
            rec["library_ms"] = (_time_ms(fn_lib, iters, flush)
                                 if fn_lib is not None else None)
        else:
            rec["ms"] = rec["plain_ms"] = rec["library_ms"] = None
        records.append(rec)
        ms = "" if rec["ms"] is None else (
            f" ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f}"
            f" library_ms={rec['library_ms']} ")
        print(f"[kernels] {rec['name']} {rec['case']}: max_abs_err="
              f"{rec['max_abs_err']:.3e} (tol {rec['tol']}){ms}"
              f" bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})")
        if not rec["pass"]:
            raise PhaseFailed(f"{rec['name']} {rec['case']} disagrees with "
                              f"its plain version: {rec}")

    for dt in dtypes:
        for model, (H, Hkv, D) in attn_shapes.items():
            for T in Ts:
                q, k, v, table, mask, bs = attention_case(device, H, Hkv, D,
                                                          T, dt)
                got = ops.paged_decode_attention(q, k, v, table, mask, bs)
                want = attention.paged_attention_plain(q, k, v, table, mask,
                                                       bs)
                err = float((got.float() - want.float()).abs().max())
                zero_row = bool((got[mask.any(-1) == 0] == 0).all())
                bms, by = _attn_bound(q, k, table, mask, bs)
                add({"name": "paged_attention",
                     "case": f"{model} T={T} {_dtname(dt)}",
                     "shape": [list(q.shape), list(k.shape),
                               list(table.shape)],
                     "dtype": _dtname(dt), "max_abs_err": err,
                     "tol": ATTN_TOL[dt],
                     "pass": err <= ATTN_TOL[dt] and zero_row,
                     "bound_ms": bms, "bound_by": by},
                    lambda: ops.paged_decode_attention(q, k, v, table, mask,
                                                       bs),
                    lambda: attention.paged_attention_plain(q, k, v, table,
                                                            mask, bs),
                    _sdpa_call(q, k, v, table, mask, bs) if timed else None)

        x, cand = verify_case(device, dt, V=V)
        am, m, s, cl = ops.verify_row_stats(x, cand)
        am0, m0, s0, cl0 = verify.verify_stats_plain(x, cand)
        exact = bool(torch.equal(am, am0) and torch.equal(m, m0))
        rel = max(float(((s - s0).abs() / s0.abs()).max()),
                  float(((cl - cl0).abs() / cl0.abs().clamp(min=1e-30)).max()))
        err = max(float((s - s0).abs().max()), float((cl - cl0).abs().max()))
        R = x.shape[0]
        bms, by = _bound(x.numel() * x.element_size() + R * 4 + 4 * R * 4,
                         5 * x.numel(), PEAK_OPS[torch.float32])
        add({"name": "verify_stats", "case": f"R={R} V={V} {_dtname(dt)}",
             "shape": list(x.shape), "dtype": _dtname(dt),
             "max_abs_err": err, "max_rel_err": rel,
             "tol": "argmax,max exact; sumexp,cand rtol 1e-5",
             "pass": exact and rel <= 1e-5, "bound_ms": bms, "bound_by": by},
            lambda: ops.verify_row_stats(x, cand),
            lambda: verify.verify_stats_plain(x, cand), None)

        a, b = dtv_case(device, dt, V=V)
        ma, sa = ops.softmax_stats(a)
        ma0, sa0 = dtv.softmax_stats_plain(a)
        rel = float(((sa - sa0).abs() / sa0).max())
        R = a.shape[0]
        bms, by = _bound(a.numel() * a.element_size() + 2 * R * 4,
                         4 * a.numel(), PEAK_OPS[torch.float32])
        add({"name": "softmax_stats", "case": f"R={R} V={V} {_dtname(dt)}",
             "shape": list(a.shape), "dtype": _dtname(dt),
             "max_abs_err": float((sa - sa0).abs().max()),
             "max_rel_err": rel, "tol": "max exact; sumexp rtol 1e-5",
             "pass": bool(torch.equal(ma, ma0)) and rel <= 1e-5,
             "bound_ms": bms, "bound_by": by},
            lambda: ops.softmax_stats(a),
            lambda: dtv.softmax_stats_plain(a), None)

        # the wrapper reads each row twice (stats pass, |p - q| pass); the
        # bound is the function's: each logit read once, the (R,) written
        got = ops.dtv(a, b)
        err = float((got - dtv.dtv_plain(a, b)).abs().max())
        bms, by = _bound(2 * a.numel() * a.element_size() + R * 4,
                         8 * a.numel(), PEAK_OPS[torch.float32])
        add({"name": "dtv", "case": f"R={R} V={V} {_dtname(dt)}",
             "shape": list(a.shape), "dtype": _dtname(dt),
             "max_abs_err": err, "tol": 1e-5, "pass": err <= 1e-5,
             "bound_ms": bms, "bound_by": by},
            lambda: ops.dtv(a, b), lambda: dtv.dtv_plain(a, b), None)
    return records


# ---------------------------------------------------------------------------
# 4. serving at full width
# ---------------------------------------------------------------------------
def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_pool(device, cfgs, dtype, seed=0):
    """The chain's models with random weights drawn on ``device`` from a
    seeded ``torch.Generator``."""
    from repro_torch.core import ModelPool
    from repro_torch.models.model import LanguageModel
    pool = ModelPool(device=device)
    for i, cfg in enumerate(cfgs):
        cfg = dataclasses.replace(cfg, dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(seed + i)
        pool.register(cfg, params=LanguageModel(cfg).init(gen, device))
    return pool


def _prompts(n, length, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(n, length),
                                                dtype=np.int32)


def _session_run(pool, target, prompts, new_tokens, device):
    """Two requests admitted, a few cycles, a third admitted mid-flight,
    cycles until all finish, all three retired."""
    from repro_torch.core import ChainRouter
    router = ChainRouter(pool, target, adaptive=True, device=device)
    L = prompts.shape[1]
    sess = router.start_session(num_slots=3, max_len=L + 2 * new_tokens + 32,
                                session_id="sess")
    sess.admit(0, prompts[0], new_tokens)
    sess.admit(1, prompts[1], new_tokens)
    cycles = 0
    for _ in range(3):
        sess.run_cycle()
        cycles += 1
    sess.admit(2, prompts[2], new_tokens)
    while sess.active.any() and cycles < 4 * new_tokens + 16:
        sess.run_cycle()
        cycles += 1
    outs = [sess.retire(s) for s in range(3)]
    sess.close()
    return outs, cycles


def phase_serving(device, cfgs, dtype=torch.bfloat16, n_prompts=4,
                  prompt_len=128, new_tokens=32, seed=0) -> dict:
    """Drive the port's main path through its entry points.  Launch
    counters are zeroed just before each run and read just after."""
    from repro_torch.core import ChainRouter
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pool = build_pool(device, cfgs, dtype, seed)
    names = tuple(c.name for c in cfgs)
    target = names[-1]
    prompts = _prompts(n_prompts, prompt_len, cfgs[-1].vocab_size, seed)
    plens = np.full(n_prompts, prompt_len)
    runs = {}

    def run(label, fn):
        ops.reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        wall = time.perf_counter() - t0
        runs[label] = {"wall_s": wall, "launches": ops.launch_counts()}
        return out

    adaptive = run("adaptive", lambda: ChainRouter(
        pool, target, adaptive=True, device=device).generate(
            prompts, plens, new_tokens, request_id="adaptive"))
    fixed = run("fixed_chain", lambda: ChainRouter(
        pool, target, adaptive=False, fixed_chain=names, fixed_window=4,
        device=device).generate(prompts, plens, new_tokens,
                                request_id="fixed"))
    sess_outs, sess_cycles = run("session", lambda: _session_run(
        pool, target, prompts, new_tokens, device))
    for label, out in (("adaptive", adaptive), ("fixed_chain", fixed)):
        runs[label].update(cycles=out.steps, tokens=out.committed_tokens,
                           chains=sorted({"->".join(c)
                                          for c, _ in out.chain_history}))
    runs["session"].update(cycles=sess_cycles,
                           tokens=int(sum(len(o) for o in sess_outs)))
    for label, rec in runs.items():
        rec["tokens_per_s"] = rec["tokens"] / rec["wall_s"]
        print(f"[serving] {label}: {rec['tokens']} tokens in "
              f"{rec['wall_s']:.3f} s ({rec['tokens_per_s']:.1f} tok/s), "
              f"{rec['cycles']} cycles, chains {rec.get('chains', '-')}, "
              f"launches {rec['launches']}")
    lengths_ok = (all(len(g) == new_tokens for g in adaptive.generated)
                  and all(len(g) == new_tokens for g in fixed.generated)
                  and all(len(o) == new_tokens for o in sess_outs))
    in_vocab = all(int(g.min()) >= 0 and int(g.max()) < cfgs[-1].vocab_size
                   for g in list(fixed.generated) + sess_outs)
    same = [bool(np.array_equal(sess_outs[i], fixed.generated[i]))
            for i in range(3)]
    print(f"[serving] session streams equal the fixed-chain streams: "
          f"{same} ({_dtname(dtype)}; exact equality is checked in fp32)")
    totals = {k: sum(r["launches"][k] for r in runs.values())
              for k in ops.launch_counts()}
    profile = (_profile_generate(pool, names, prompts, plens, new_tokens,
                                 device, runs["fixed_chain"]["wall_s"])
               if cuda else None)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    print(f"[serving] launches on the main path: {totals}; peak memory "
          f"{peak if peak is None else f'{peak:.2f} GiB'}")
    if not (lengths_ok and in_vocab):
        raise PhaseFailed("serving produced streams of the wrong length or "
                          "out-of-vocabulary tokens")
    return {"runs": runs, "launches": totals, "peak_gib": peak,
            "profile": profile}


KERNEL_CLASSES = (("paged_attention", ("paged_attention_kernel",)),
                  ("row_kernels", ("_verify_stats_body", "_softmax_stats_body",
                                   "_dtv_body")),
                  ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")))


def _profile_generate(pool, names, prompts, plens, new_tokens, device,
                      plain_wall_s):
    """One more fixed-chain ``generate`` under ``torch.profiler``: device
    time by kernel class and by kernel (not counted in the launch totals
    above).  The busy share divides that device time by the wall time of
    the same run without the profiler (``plain_wall_s``), since tracing
    slows the host."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ChainRouter
    router = ChainRouter(pool, names[-1], adaptive=False, fixed_chain=names,
                         fixed_window=4, device=device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync(device)
        t0 = time.perf_counter()
        router.generate(prompts, plens, new_tokens, request_id="profiled")
        _sync(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if "CUDA" in str(getattr(e, "device_type", ""))]
    if not kernels:
        print("[serving] profile: the profiler recorded no device time; "
              "device busy share not measured")
        return None
    by_name: dict = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + us, n + 1)
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3
    classes = {c: 0.0 for c, _ in KERNEL_CLASSES}
    classes["other"] = 0.0
    for name, (t, _) in by_name.items():
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in name for k in keys)), "other")
        classes[cls] += t / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"profiled_wall_s": wall, "wall_s": plain_wall_s,
           "device_busy_ms": busy_ms,
           "busy_share": busy_ms / 1e3 / plain_wall_s, "class_ms": classes,
           "top": [{"kernel": k[:90], "ms": t / 1e3, "launches": n}
                   for k, (t, n) in top]}
    print(f"[serving] profile (fixed chain): device busy {busy_ms:.1f} ms "
          f"= {out['busy_share']:.1%} of the unprofiled {plain_wall_s:.3f} s "
          f"(profiled wall {wall:.3f} s); "
          f"by class ms {({c: round(v, 1) for c, v in classes.items()})}")
    for row in out["top"]:
        print(f"[serving]   {row['ms']:8.2f} ms {row['launches']:6d}x "
              f"{row['kernel']}")
    return out


# ---------------------------------------------------------------------------
# 5. output guarantee (fp32)
# ---------------------------------------------------------------------------
def _top2_gap(pool, model, context: np.ndarray, device) -> float:
    """Gap between the model's two largest next-token logits after
    ``context``."""
    lm = pool.model(model)
    state = lm.make_state(1, len(context) + 1, device=device)
    logits, _ = lm.prefill(pool.params(model), state,
                           torch.as_tensor(context[None], device=device))
    top = logits[0].topk(2).values
    return float(top[0] - top[1])


def phase_output(device, cfgs, n_prompts=4, prompt_len=128, new_tokens=32,
                 seed=0, tie_gap=1e-3) -> dict:
    """Speculative greedy (all three models, window 4) against target-only
    greedy on the same fp32 weights.  Verify blocks and single-token steps
    use different GEMM shapes, so a divergence is accepted only at a
    near-tie of the target (top-2 logit gap < ``tie_gap``)."""
    from repro_torch.core import ChainRouter
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pool = build_pool(device, cfgs, torch.float32, seed)
    names = tuple(c.name for c in cfgs)
    target = names[-1]
    prompts = _prompts(n_prompts, prompt_len, cfgs[-1].vocab_size, seed)
    plens = np.full(n_prompts, prompt_len)
    spec = ChainRouter(pool, target, adaptive=False, fixed_chain=names,
                       fixed_window=4, device=device).generate(
                           prompts, plens, new_tokens, request_id="spec")
    ref = ChainRouter(pool, target, adaptive=False, fixed_chain=(target,),
                      fixed_window=1, device=device).generate(
                          prompts, plens, new_tokens, request_id="ref")
    divergences = []
    for b in range(n_prompts):
        got, want = spec.generated[b], ref.generated[b]
        if np.array_equal(got, want):
            continue
        n = min(len(got), len(want))
        pos = int(np.argmax(got[:n] != want[:n])) if \
            np.any(got[:n] != want[:n]) else n
        gap = _top2_gap(pool, target, ref.sequences[b][:prompt_len + pos],
                        device)
        divergences.append({"row": b, "position": pos, "top2_gap": gap})
        print(f"[output] row {b} diverges at generated position {pos}: "
              f"target top-2 logit gap {gap:.3e} (tolerated below "
              f"{tie_gap})")
        if gap >= tie_gap:
            raise PhaseFailed(f"speculative output differs from target-only "
                              f"greedy at row {b} position {pos} without a "
                              f"near-tie (gap {gap:.3e})")
    print(f"[output] fp32 fixed chain vs target-only: "
          f"{n_prompts - len(divergences)}/{n_prompts} rows identical, "
          f"{spec.steps} vs {ref.steps} cycles")
    return {"identical_rows": n_prompts - len(divergences),
            "rows": n_prompts, "divergences": divergences,
            "cycles": {"speculative": spec.steps, "target_only": ref.steps}}


# ---------------------------------------------------------------------------
REPRESENTATIVE = {"paged_attention": "llama-2-7b T=5 bfloat16",
                  "verify_stats": "R=20 V=32000 float32",
                  "softmax_stats": "R=4 V=32000 float32",
                  "dtv": "R=4 V=32000 float32"}


def kernels_line(records, launches) -> list:
    """One entry per kernel at its representative main-path case (bf16
    attention as served; fp32 logits for the row reductions)."""
    out = []
    for name, case in REPRESENTATIVE.items():
        rec = next(r for r in records
                   if r["name"] == name and r["case"] == case)
        route, source = ROUTES[name]
        out.append({"name": name, "route": route, "source": source,
                    "replaces": REPLACES[name], "launches": launches[name],
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec["library_ms"], "case": case})
    return out


def main() -> int:
    try:
        dev = phase_device()
        build_s = phase_build("cuda")
        records = phase_kernels("cuda")
        from repro_torch.configs import llama_pool
        chain = llama_pool.full_pool()[:3]
        serving = phase_serving("cuda", chain)
        gc.collect()
        torch.cuda.empty_cache()
        output = phase_output("cuda", chain)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    missing = [k for k, n in serving["launches"].items() if n <= 0]
    if missing:
        print(f"chip_smoke: FAILED: kernels never launched on the main path: "
              f"{missing}", file=sys.stderr)
        return 1
    line = kernels_line(records, serving["launches"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": dev, "build_s": build_s, "cases": records,
         "serving": serving, "output": output, "kernels": line}, indent=1))
    print(f"[device] {dev['smi']}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
