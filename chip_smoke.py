#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py        # needs one CUDA card; ~4 minutes

Phases, each printing its own lines:

1. device  — the card's name and power limit (``nvidia-smi``); no card,
             no run (exit 1).
2. build   — compile the three CUDA sources with nvcc (one process per
             source, all started together).
3. kernels — every kernel against its plain PyTorch version at the main
             path's shapes, fp32 and bf16, with CUDA-event times, the
             plain version's time, the roofline bound and a library
             yardstick where one PyTorch call computes the same function
             (timed only; the port never calls it):
             ``F.scaled_dot_product_attention`` on contiguous K/V for the
             attention kernels, ``torch.topk`` for the tree-draft top-k.
             Attention runs causal verify masks, token-tree ancestor rows
             with dead-branch holes, rollback holes and a fully masked row
             (which must be exactly 0), at S=256 and at long context
             (paged R=128x32, contiguous S=4096); each case prints its
             key-split plan, must repeat bit for bit, and in fp32 at long
             context a row of a T=1 launch must equal the last row of the
             T=5 launch.
             The softmax statistics and ``dtv`` (one launch, as the probe
             calls it) run at R=1 and R=4 rows (an admission's and boot's
             probe) of V, V+1 and the long vocabularies, and on rows with
             a row stride of V+1.  The row kernels (verify stats, top-k)
             also run at V+1 (odd, misaligned rows), at the published
             vocabularies 151936 and 262144, on a strided (B, T+1, V)
             verify view and at k=8, with ties on their slice boundaries.  Each row case
             prints its plan (cluster size, CTAs), must repeat bit for bit
             and gives its share of the bytes bound and its time without
             the flush.
             Then the floor (an empty kernel timed the same way, with and
             without the flush) and the host microseconds per call of
             ``ops.verify_row_stats``, ``ops.draft_topk``, ``ops.dtv`` and
             ``ops.softmax_stats``.
4. serving — the full-width Llama chain llama-68m -> tinyllama-1.1b ->
             llama-2-7b in bf16 with random weights, through
             ``ChainRouter.generate`` / ``RouterSession`` on the fused
             cycle (the default: one replayed CUDA graph per group): on
             the paged state adaptive linear, fixed chain (window 4), a
             session with a mid-flight admission, a fixed-chain token tree
             (2x2x1) and adaptive trees (2x1, 2x1x1, 2x2x1; the scheduler
             must pick a tree); on the contiguous state (``paged=False``)
             a fixed-chain linear and a tree run; and the per-op twins
             (``fused=False``) of the paged fixed-chain and tree runs.
             Launch counters are zeroed just before each run and read just
             after (a replay adds the launches its capture recorded);
             every kernel must have launched on this phase (the softmax
             statistics as pass 1 of the ``dtv`` launches), and every
             fused run must have run a group fused.  Each run prints a
             ``[fused]`` line: groups fused and per-op (by reason), host
             syncs per cycle, the median cycle wall, graph captures,
             re-stages and capture seconds.  One more fixed-chain and one
             tree session each run a fused group under
             ``torch.cuda.set_sync_debug_mode("error")``: only the
             summary's wait may synchronise.  The paged fixed-chain and
             tree runs, fused and per-op, and the contiguous runs then run
             again under ``torch.profiler`` (not counted): device time by
             kernel class and the device busy share, the source of
             PERF.md's "Where the time goes".
5. output  — the same chain in fp32 (TF32 off), fused and per-op: the
             speculative greedy streams of the paged linear, paged tree,
             contiguous linear and contiguous tree paths must equal
             target-only greedy, or diverge only where the target's top-2
             logit gap is below 1e-3.  So must two paths through a twin of
             the target (its weights under another name), whose drafts
             are accepted: a paged 2x2x1 tree, and a contiguous session of
             tree and linear slots with a mid-flight admission and rows so
             short that the capacity guard defragments.  Both must keep
             drafts.

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
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core.token_tree import TokenTree  # noqa: E402
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
    "masked_decode_attention": "src/repro/kernels/attention.py:76",
    "masked_tree_attention": "src/repro/kernels/attention.py:152",
    "draft_topk": "src/repro/kernels/verify.py:133",
}
ROUTES = {"paged_attention": ("cuda", attention.SOURCE),
          "verify_stats": ("cuda", verify.SOURCE),
          "softmax_stats": ("cuda", dtv.SOURCE),
          "dtv": ("cuda", dtv.SOURCE),
          "masked_decode_attention": ("cuda", attention.MASKED_SOURCE),
          "masked_tree_attention": ("cuda", attention.MASKED_SOURCE),
          "draft_topk": ("cuda", verify.SOURCE)}
TREE = TokenTree((2, 2, 1))        # the smoke's tree shape: 10 nodes


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
    """nvcc every CUDA source, one process each, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = [pool.submit(attention._launcher),
                  pool.submit(attention.masked_launchers),
                  pool.submit(verify.launchers)]
        for b in builds:
            b.result()
    secs = time.perf_counter() - t0
    print(f"[build] kernels built in {secs:.1f} s")
    for src, lines in ptxas_report().items():
        regs = [int(n) for ln in lines
                for n in re.findall(r"Used (\d+) registers", ln)]
        spills = [ln for ln in lines
                  if "spill" in ln and not ln.startswith("0 bytes")]
        print(f"[build] {src}: {len(regs)} kernels, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, "
              f"{len(spills)} with spills (chip_smoke.json has each)")
    return secs


def ptxas_report() -> dict:
    """nvcc's ``-Xptxas -v`` lines per CUDA source: each kernel's
    registers, shared memory and spills."""
    return {src: [ln.strip() for ln in log.splitlines()
                  if "ptxas info" in ln or "spill" in ln]
            for src, log in build.BUILD_LOGS.items()}


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------
ATTN_SHAPES = {"llama-2-7b": (32, 32, 128), "tinyllama-1.1b": (32, 4, 64)}


def _row_masks(lens, T, S, kind, holes):
    """(B, T, S) per-query masks for rows holding ``lens[b]`` entries whose
    last T are the query block.  ``causal``: query t sees slots up to
    n - T + t (a verify block).  ``tree``: the block is a 2x2x1 token tree
    (T = 10); query i sees the committed prefix and its ancestors-or-self.
    ``holes`` masks slots inside the prefix (rollback and dead-branch
    holes of earlier cycles).  A row with n = 0 is fully masked (an
    inactive slot)."""
    mask = torch.zeros(len(lens), T, S, dtype=torch.bool)
    for b, n in enumerate(lens):
        if n == 0:
            continue
        if kind == "tree":
            mask[b, :, :n - T] = True
            mask[b, :, n - T:n] = torch.as_tensor(TREE.attend)
        else:
            for t in range(T):
                mask[b, t, :max(n - T + 1 + t, 0)] = True
        if holes and n > 2 * T + 40:
            mask[b, :, 20:23] = False
            mask[b, :, n // 2:n // 2 + 4] = False
    return mask


def attention_case(device, H, Hkv, D, T, dtype, B=4, bs=32, R=8, seed=0,
                   kind="causal", lens=None):
    """Paged operands at main-path shapes: per-row block tables with
    unallocated (-1) entries, per-query masks (``_row_masks``) over rows of
    ``lens`` entries and one fully masked row (an inactive slot)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    P = B * R + 8
    if lens is None:
        lens = [min(200, R * bs), 131, 77, 0][:B] + [64] * max(0, B - 4)
    table = torch.full((B, R), -1, dtype=torch.int32)
    perm = torch.randperm(P, generator=g)
    used = 0
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        table[b, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb
    mask = _row_masks(lens, T, R * bs, kind, holes=kind == "tree")
    q = torch.randn(B, T, H, D, generator=g)
    k = torch.randn(P * bs, Hkv, D, generator=g)
    v = torch.randn(P * bs, Hkv, D, generator=g)
    to = dict(device=device)
    return (q.to(dtype=dtype, **to), k.to(dtype=dtype, **to),
            v.to(dtype=dtype, **to), table.to(**to), mask.to(**to), bs)


def contiguous_case(device, H, Hkv, D, T, dtype, B=4, S=256, seed=4,
                    kind="causal", lens=None):
    """Contiguous-state operands: (B, S, Hkv, D) caches, per-query masks
    with rollback holes (``_row_masks``) over rows of ``lens`` entries and
    one fully masked row."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if lens is None:
        lens = [S - 6, 131, 77, 0][:B] + [64] * max(0, B - 4)
    mask = _row_masks(lens, T, S, kind, holes=True)
    q = torch.randn(B, T, H, D, generator=g)
    k = torch.randn(B, S, Hkv, D, generator=g)
    v = torch.randn(B, S, Hkv, D, generator=g)
    to = dict(device=device, dtype=dtype)
    return q.to(**to), k.to(**to), v.to(**to), mask.to(device)


def _n_sm(device) -> int:
    dev = torch.device(device)
    return device_mod.sm_count(dev) if dev.type == "cuda" else 132


def row_plan(device, R, V, dtype) -> tuple:
    """``verify.row_split_plan`` of a launch over R rows of V ``dtype``
    logits on ``device`` (132 SMs off the card)."""
    return verify.row_split_plan(R, V, torch.finfo(dtype).bits // 8,
                                 _n_sm(device))


def _boundary_ties(device, R, V, dtype) -> list:
    """Column pairs (b - 1, b) around every slice start b > 0 of the row
    kernels' plan for this launch."""
    C, per = row_plan(device, R, V, dtype)
    return [(lo - 1, lo) for lo, _ in verify.slice_ranges(V, C, per)[1:]
            if 0 < lo < V]


def verify_case(device, dtype, R=20, V=32000, seed=1):
    """Logits rows with planted argmax ties inside one tile, across tiles,
    at the vocabulary's ends and on the row kernels' slice boundaries
    (rows 5..); half the candidates are the argmax."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(R, V, generator=g) * 3.0
    ties = [(5, 6), (100, 2100), (0, V - 1), (2047, 2048), (17, V - 2000)]
    ties += _boundary_ties(device, R, V, dtype)
    for r, (a, b) in enumerate(ties[:R]):
        top = x[r].max() + 1.0
        x[r, a] = top
        x[r, b] = top
    x = x.to(dtype)
    cand = torch.randint(0, V, (R,), generator=g, dtype=torch.int32)
    am = x.float().argmax(dim=-1).to(torch.int32)
    cand[::2] = am[::2]
    return x.to(device), cand.to(device)


def dtv_case(device, dtype, R=4, V=32000, seed=2, stride=None):
    """Two models' logits rows, b near a; the last of several rows of b is
    -inf at every fifth column.  ``stride``: a's rows are (R, V) of an
    (R, stride) array, so its rows start at other 16-byte phases than b's."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(R, V, generator=g) * 2.0
    b = a + 0.5 * torch.randn(R, V, generator=g)
    if R > 1:
        b[-1, ::5] = -torch.inf
    to = dict(device=device, dtype=dtype)
    a, b = a.to(**to), b.to(**to)
    if stride:
        a = torch.zeros(R, stride, **to)[:, :V].copy_(a)
    return a, b


def topk_case(device, dtype, R, V=32000, seed=3):
    """Tree-draft logits rows with planted ties: inside one 2048-wide tile,
    across a tile boundary, at both ends of the vocabulary, a three-way tie
    for the maximum, a tie for second place (row 6) and, from row 7, ties
    on the row kernels' slice boundaries."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(R, V, generator=g) * 3.0
    ties = [(5, 6), (2047, 2048), (0, V - 1), (100, 2100, V - 2000),
            (V - 2, V - 1), (4095, 4096, 4097)]
    for r, cols in enumerate(ties[:R]):
        top = x[r].max() + 1.0
        for c in cols:
            x[r, c % V] = top
    if R > len(ties):                      # second-place tie below a max
        r = len(ties)
        top = x[r].max()
        x[r, 7] = top + 2.0
        x[r, [300, 9000 % V]] = top + 1.0
    for r, cols in enumerate(_boundary_ties(device, R, V, dtype)[:max(0, R - 7)],
                             start=7):
        x[r, list(cols)] = x[r].max() + 1.0
    return x.to(device=device, dtype=dtype)


def _time_ms(fn, iters: int, flush) -> float:
    """Median device time of ``fn`` from CUDA events, L2 evicted before
    each launch by writing ``flush`` (main-path callers find these operands
    cold; ``flush=None`` times warm launches).  A leading device sleep lets
    the host enqueue every launch before the device reaches them, so host
    overhead stays out of the events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for e0, e1 in ev:
        if flush is not None:
            flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in ev]))


def _attn_bound(q, Hkv, mask, table=None) -> tuple:
    B, T, H, D = q.shape
    elt = q.element_size()
    # K and V of the keys that some query of the row attends to
    kv_bytes = int(mask.any(dim=1).sum()) * Hkv * D * elt * 2
    nbytes = (2 * q.numel() * elt + kv_bytes + mask.numel()
              + (table.numel() * 4 if table is not None else 0))
    ops_count = 4 * H * D * int(mask.sum())
    return _bound(nbytes, ops_count, PEAK_OPS[q.dtype])


def _bound(nbytes: float, ops_count: float, peak: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_call(q, k, v, mask, table=None, bs=None):
    """F.scaled_dot_product_attention on the same function's inputs: K/V
    contiguous per row (a paged pool is gathered first) and repeated over
    the GQA group, outside the timing."""
    B, T, H, D = q.shape
    if table is not None:
        S = table.shape[1] * bs
        s = torch.arange(S, device=q.device)
        flat = table[:, s // bs].long().clamp(min=0) * bs \
            + (s % bs)[None, :]
        k, v = k[flat], v[flat]
    Hkv = k.shape[2]
    kk = k.permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1)
    vv = v.permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1)
    qq = q.permute(0, 2, 1, 3).contiguous()
    kk, vv = kk.contiguous(), vv.contiguous()
    am = mask[:, None].contiguous()
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=am)


def phase_kernels(device, dtypes=(torch.float32, torch.bfloat16),
                  attn_shapes=None, V=32000, iters=50, timed=True,
                  long_S=4096, long_V=(151936, 262144)) -> list:
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

    def attn(name, case, kernel, plain, bound, lib, shape, plan,
             same_row=None):
        """One attention case: the kernel's output against its plain
        version, a fully masked last row that must be exactly 0, a second
        launch that must agree bit for bit, and (``same_row``) a query row
        that must not depend on the block it is launched in."""
        got, want = kernel(), plain()
        again = kernel()
        err = float((got.float() - want.float()).abs().max())
        # a fully masked query row must give zeros, not NaN
        zero_row = bool((got.reshape(got.shape[0], -1)[-1] == 0).all())
        repeat = bool(torch.equal(got, again))
        rec = {"name": name, "case": case, "shape": shape,
               "dtype": _dtname(got.dtype), "max_abs_err": err,
               "tol": ATTN_TOL[got.dtype], "zero_row": zero_row,
               "bitwise_repeat": repeat, "splits": plan[0],
               "ctas": plan[1]}
        ok = err <= ATTN_TOL[got.dtype] and zero_row and repeat
        if same_row is not None:
            rec["t1_equals_last_row"] = bool(same_row(got))
            ok = ok and rec["t1_equals_last_row"]
        print(f"[kernels] {name} {case}: plan splits={plan[0]} "
              f"ctas={plan[1]} zero_row={zero_row} bitwise_repeat={repeat}"
              f"{'' if same_row is None else ' t1_equals_last_row=' + str(rec['t1_equals_last_row'])}")
        rec.update({"pass": ok, "bound_ms": bound[0], "bound_by": bound[1]})
        add(rec, kernel, plain, lib)

    def plan(q, Hkv, S, bs):
        """(splits, CTAs) of this launch."""
        B, T, H, _ = q.shape
        n_sm = (device_mod.sm_count(q.device) if q.device.type == "cuda"
                else 132)
        splits, _ = attention.split_plan(B, Hkv, S, bs, n_sm)
        rows = T * (H // Hkv)
        return splits, splits * -(-rows // attention.row_tile(rows)) * Hkv * B

    def paged(model, H, Hkv, D, T, dt, kind, tag, R=8, lens=None):
        q, k, v, table, mask, bs = attention_case(device, H, Hkv, D, T, dt,
                                                  kind=kind, R=R, lens=lens)
        same_row = None
        if lens is not None and dt == torch.float32 and T > 1:
            def same_row(got):
                one = ops.paged_decode_attention(q[:, -1:], k, v, table,
                                                 mask[:, -1:], bs)
                return torch.equal(one[:, 0], got[:, -1])
        attn("paged_attention", f"{model} T={T}{tag} {_dtname(dt)}",
             lambda: ops.paged_decode_attention(q, k, v, table, mask, bs),
             lambda: attention.paged_attention_plain(q, k, v, table, mask,
                                                     bs),
             _attn_bound(q, Hkv, mask, table),
             _sdpa_call(q, k, v, mask, table, bs) if timed else None,
             [list(q.shape), list(k.shape), list(table.shape)],
             plan(q, Hkv, table.shape[1] * bs, bs), same_row)

    def contiguous(model, H, Hkv, D, T, dt, kind, tag, S=256, lens=None):
        q, k, v, mask = contiguous_case(device, H, Hkv, D, T, dt, kind=kind,
                                        S=S, lens=lens)
        S = k.shape[1]
        if T == 1:
            q1, m1 = q[:, 0], mask[:, 0]
            attn("masked_decode_attention",
                 f"{model} T=1 S={S}{tag} {_dtname(dt)}",
                 lambda: ops.masked_decode_attention(q1, k, v, m1),
                 lambda: attention.masked_decode_attention_plain(q1, k, v,
                                                                 m1),
                 _attn_bound(q, Hkv, mask),
                 _sdpa_call(q, k, v, mask) if timed else None,
                 [list(q1.shape), list(k.shape)], plan(q, Hkv, S, S))
            return
        same_row = None
        if lens is not None and dt == torch.float32:
            def same_row(got):
                one = ops.masked_decode_attention(q[:, -1], k, v,
                                                  mask[:, -1])
                return torch.equal(one, got[:, -1])
        attn("masked_tree_attention",
             f"{model} T={T}{tag} S={S} {_dtname(dt)}",
             lambda: ops.masked_tree_attention(q, k, v, mask),
             lambda: attention.masked_tree_attention_plain(q, k, v, mask),
             _attn_bound(q, Hkv, mask),
             _sdpa_call(q, k, v, mask) if timed else None,
             [list(q.shape), list(k.shape)], plan(q, Hkv, S, S), same_row)

    def row_case(name, case, x, cand=None, k=None):
        """One row-kernel case (verify stats with ``cand``, else the top-k):
        the kernel against its plain version on the same rows, a second
        launch that must agree bit for bit, the launch plan, the bytes
        bound and, when timed, the time without the L2 flush too."""
        rows = x.reshape(-1, x.shape[-1])
        R, Vx = rows.shape
        if cand is not None:
            kernel = lambda: ops.verify_row_stats(x, cand)
            plain = lambda: verify.verify_stats_plain(rows, cand.reshape(-1))
            lib = None
        else:
            kernel = lambda: ops.draft_topk(x, k)
            plain = lambda: verify.topk_plain(x, k)
            lib = lambda: torch.topk(x, k, dim=-1)
        got, again, want = kernel(), kernel(), plain()
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        if cand is not None:
            am, m, s, cl = (t.reshape(-1) for t in got)
            am0, m0, s0, cl0 = want
            ok = bool(torch.equal(am, am0) and torch.equal(m, m0))
            rel = max(float(((s - s0).abs() / s0.abs()).max()),
                      float(((cl - cl0).abs()
                             / cl0.abs().clamp(min=1e-30)).max()))
            fields = {"max_abs_err": max(float((s - s0).abs().max()),
                                         float((cl - cl0).abs().max())),
                      "max_rel_err": rel,
                      "tol": "argmax,max exact; sumexp,cand rtol 1e-5"}
            ok = ok and rel <= 1e-5
            nbytes = rows.numel() * rows.element_size() + R * 4 + 4 * R * 4
            nops = 5 * rows.numel()
        else:
            err = float((got[0] - want[0]).abs().max())
            fields = {"max_abs_err": err, "tol": "indices exact; values 0"}
            ok = bool(torch.equal(got[1], want[1])) and err == 0.0
            nbytes = rows.numel() * rows.element_size() + R * k * 8
            nops = k * rows.numel()
        row_record(name, case, x, R, Vx, fields, ok, repeat, nbytes, nops,
                   kernel, plain, lib)

    def row_record(name, case, x, R, Vx, fields, ok, repeat, nbytes, nops,
                   kernel, plain, lib):
        """A row kernel's record: its launch plan, the bytes bound and,
        when timed, the bound's share and the time without the flush."""
        C, _ = row_plan(device, R, Vx, x.dtype)
        print(f"[kernels] {name} {case}: plan C={C} ctas={R * C} "
              f"bitwise_repeat={repeat}")
        bms, by = _bound(nbytes, nops, PEAK_OPS[torch.float32])
        rec = {"name": name, "case": case, "shape": list(x.shape),
               "dtype": _dtname(x.dtype), **fields, "cluster": C,
               "ctas": R * C, "bitwise_repeat": repeat, "pass": ok and repeat,
               "bound_ms": bms, "bound_by": by}
        add(rec, kernel, plain, lib)
        if timed:
            rec["bound_share"] = bms / rec["ms"]
            rec["warm_ms"] = _time_ms(kernel, iters, None)
            print(f"[kernels] {name} {case}: {rec['bound_share']:.1%} of the "
                  f"bound; {rec['warm_ms']:.4f} ms without the L2 flush")

    def pair_case(case, a, b=None):
        """One softmax-statistics case (``b`` None) or DTV case: the kernel
        against its plain version and a second launch that must agree bit
        for bit.  The bound is the function's: each logit read once, the
        outputs written once."""
        R, Vx = a.shape
        elt = a.element_size()
        if b is None:
            name = "softmax_stats"
            kernel = lambda: ops.softmax_stats(a)
            plain = lambda: dtv.softmax_stats_plain(a)
            (m, s), again, (m0, s0) = kernel(), kernel(), plain()
            repeat = bool(torch.equal(m, again[0]) and torch.equal(s, again[1]))
            rel = float(((s - s0).abs() / s0).max())
            fields = {"max_abs_err": float((s - s0).abs().max()),
                      "max_rel_err": rel, "tol": "max exact; sumexp rtol 1e-5"}
            ok = bool(torch.equal(m, m0)) and rel <= 1e-5
            nbytes, nops = a.numel() * elt + 2 * R * 4, 4 * a.numel()
        else:
            name = "dtv"
            kernel = lambda: ops.dtv(a, b)
            plain = lambda: dtv.dtv_plain(a, b)
            got, again, want = kernel(), kernel(), plain()
            repeat = bool(torch.equal(got, again))
            err = float((got - want).abs().max())
            fields = {"max_abs_err": err, "tol": 1e-5}
            ok = err <= 1e-5
            nbytes, nops = 2 * a.numel() * elt + R * 4, 8 * a.numel()
        row_record(name, case, a, R, Vx, fields, ok, repeat, nbytes, nops,
                   kernel, plain, None)

    first = next(iter(attn_shapes))     # llama-2-7b: fp32 long cases too
    for dt in dtypes:
        for model, (H, Hkv, D) in attn_shapes.items():
            for T, kind in ((1, "causal"), (5, "causal"), (10, "tree")):
                paged(model, H, Hkv, D, T, dt, kind,
                      " tree" if kind == "tree" else "")
            for T, kind in ((1, "causal"), (5, "causal"), (10, "tree")):
                contiguous(model, H, Hkv, D, T, dt, kind,
                           " tree" if kind == "tree" else "")
            # long context: rows of S-6, 3S/4, S/2 and 0 entries
            S = long_S
            lens = [S - 6, 3 * S // 4, S // 2, 0]
            for T in (1, 5):
                if dt == torch.bfloat16 or (model == first and T == 5):
                    paged(model, H, Hkv, D, T, dt, "causal",
                          f" R={S // 32}x32", R=S // 32, lens=lens)
                    contiguous(model, H, Hkv, D, T, dt, "causal", "", S=S,
                               lens=lens)

        # verify row stats: the main path's R=20 (B=4 x T+1=5) rows, a row
        # of odd length (hymba-1.5b, misaligned rows), the published
        # vocabularies of qwen1.5-4b and gemma3-27b, and a verify block's
        # (B, T+1, V) view of the forward's logits
        for Vx in (V, V + 1, *long_V):
            x, cand = verify_case(device, dt, V=Vx)
            row_case("verify_stats", f"R=20 V={Vx} {_dtname(dt)}", x, cand)
        x, cand = verify_case(device, dt, R=32, V=V)
        view = x.reshape(4, 8, V)[:, 3:]
        row_case("verify_stats", f"B=4 T+1=5 view V={V} {_dtname(dt)}",
                 view, cand.reshape(4, 8)[:, 3:].contiguous())
        # the tree verify's rows: B=4 x (the 2x2x1 tree's nodes + 1) = 44,
        # which plans a smaller cluster than the linear verify's 20
        R = 4 * (TREE.num_nodes + 1)
        x, cand = verify_case(device, dt, R=R, V=V)
        row_case("verify_stats", f"R={R} tree V={V} {_dtname(dt)}", x, cand)

        # the SimScore probe: one row at an admission, the batch's four at
        # boot, over the chain's vocabulary, a row of odd length and the
        # long vocabularies; then rows of stride V+1 (a's rows start at
        # other 16-byte phases than b's)
        for R in (1, 4):
            for Vx in (V, V + 1, *long_V):
                a, b = dtv_case(device, dt, R=R, V=Vx)
                pair_case(f"R={R} V={Vx} {_dtname(dt)}", a)
                pair_case(f"R={R} V={Vx} {_dtname(dt)}", a, b)
        a, b = dtv_case(device, dt, V=V, stride=V + 1)
        pair_case(f"R=4 V={V} row stride {V + 1} {_dtname(dt)}", a)
        pair_case(f"R=4 V={V} row stride {V + 1} {_dtname(dt)}", a, b)

        # every (R, k) the tree runs launch at B = 4: 2x2x1 expands 1, 2
        # and 4 parents per row with k = 2, 2, 1; 2x1x1 and 2x1 expand 1
        # and then 2 with k = 2 and then 1; then k = 8, a row of odd
        # length and the published long vocabularies at R = 16, k = 2
        topk_cases = [(R, V, k) for k in (1, 2) for R in (4, 8, 16)]
        topk_cases += [(16, V, 8), (16, V + 1, 2)]
        topk_cases += [(16, Vx, 2) for Vx in long_V]
        for R, Vx, k in topk_cases:
            x = topk_case(device, dt, R, V=Vx)
            row_case("draft_topk", f"R={R} V={Vx} k={k} {_dtname(dt)}", x,
                     k=k)
    return records


def kernel_floor(device, iters=200) -> dict:
    """The timing method's own floor: a kernel that does nothing (torch's
    one-thread spin kernel, ``torch.cuda._sleep``, asked for 0 cycles)
    timed by ``_time_ms`` with the 256 MB L2 flush before each launch and
    without it.  Off the card there is nothing to time."""
    if torch.device(device).type != "cuda":
        return {"flushed_ms": None, "unflushed_ms": None}
    launch = lambda: torch.cuda._sleep(0)
    flush = torch.empty(256 << 20, dtype=torch.int8, device=device)
    out = {"flushed_ms": _time_ms(launch, iters, flush),
           "unflushed_ms": _time_ms(launch, iters, None)}
    print(f"[kernels] floor: empty kernel {out['flushed_ms']:.4f} ms with "
          f"the 256 MB flush, {out['unflushed_ms']:.4f} ms without")
    return out


def host_cost(device, V=32000, calls=1000, m=ops) -> dict:
    """Median host microseconds per call of ``m.verify_row_stats`` (R=20
    rows), ``m.draft_topk`` (R=16, k=2), ``m.dtv`` and ``m.softmax_stats``
    (R=4, the probe's rows at boot) on fp32 rows of V: ``calls`` calls each
    after 20 of warm-up, a sync only before every 100th call (outside the
    timing) so the launch queue stays shallow.  ``m`` is a port's
    ``kernels.ops`` (``tools/host_cost_ab.py`` passes another
    checkout's)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(20, V, generator=g).to(device)
    cand = torch.zeros(20, dtype=torch.int32, device=device)
    t = torch.randn(16, V, generator=g).to(device)
    a, b = x[:4], x[4:8]
    out = {}
    for op, fn in (("verify_row_stats", lambda: m.verify_row_stats(x, cand)),
                   ("draft_topk", lambda: m.draft_topk(t, 2)),
                   ("dtv", lambda: m.dtv(a, b)),
                   ("softmax_stats", lambda: m.softmax_stats(a))):
        for _ in range(20):
            fn()
        us = []
        for i in range(calls):
            if i % 100 == 0:
                _sync(device)
            t0 = time.perf_counter_ns()
            fn()
            us.append((time.perf_counter_ns() - t0) / 1e3)
        _sync(device)
        out[op] = float(np.median(us))
    return out


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


def serving_runs(names) -> dict:
    """Label -> ``ChainRouter`` options of phase 4's ``generate`` runs (and
    of phase 5's speculative paths)."""
    fixed = dict(adaptive=False, fixed_chain=names)
    return {"adaptive": dict(adaptive=True),
            "fixed_chain": dict(fixed, fixed_window=4),
            "paged_tree": dict(fixed, fixed_tree=str(TREE)),
            # at the random pool's SimScore Eq. 7 ranks the 2x1 tree
            # ahead of every linear window, so the scheduler's tree
            # choice runs on the card
            "adaptive_tree": dict(adaptive=True,
                                  tree_shapes=("2x1", "2x1x1", str(TREE))),
            "contiguous_linear": dict(fixed, fixed_window=4, paged=False),
            "contiguous_tree": dict(fixed, fixed_tree=str(TREE),
                                    paged=False)}


# runs that also run per-op (``fused=False``), as "<label>_per_op"
PER_OP_TWINS = ("fixed_chain", "paged_tree")
# kernels that a run must have launched (phase 4 checks them per run)
RUN_NEEDS = {"paged_tree": ("draft_topk", "paged_attention",
                            "verify_stats"),
             "fixed_chain": ("paged_attention", "verify_stats"),
             "adaptive_tree": ("draft_topk",),
             "contiguous_linear": ("masked_decode_attention",
                                   "masked_tree_attention"),
             "contiguous_tree": ("draft_topk", "masked_decode_attention",
                                 "masked_tree_attention")}
PROFILED = ("fixed_chain", "fixed_chain_per_op", "paged_tree",
            "paged_tree_per_op", "contiguous_linear", "contiguous_tree")


def fused_stats(router, cycle_wall_s) -> dict:
    """The ``[fused]`` line of one run: groups fused and per-op (by
    reason), host syncs per cycle outside admission (prefill and insert),
    the median cycle wall, graph captures, re-stages and capture
    seconds."""
    c = router.profiler.counters
    admission = sum(v for k, v in c.items()
                    if k.endswith(".calls") and k.split(".")[0] in
                    ("prefill", "insert"))
    cycles = len(cycle_wall_s)
    return {"groups_fused": int(c["groups.fused"]),
            "groups_per_op": int(c["groups.per_op"]),
            "per_op_reasons": {k.split(".")[-1]: int(v) for k, v in c.items()
                               if k.startswith("groups.per_op.")},
            "host_syncs_per_cycle": (c["host_sync"] - admission)
            / max(cycles, 1),
            "median_cycle_wall_s": float(np.median(cycle_wall_s))
            if cycles else None,
            "graph_captures": int(c["graph_capture"]),
            "graph_restages": int(c["graph_restage"]),
            "capture_s": float(c["graph_capture_s"])}


def _print_fused(label, st) -> None:
    print(f"[fused] {label}: groups fused {st['groups_fused']}, per-op "
          f"{st['groups_per_op']} {st['per_op_reasons']}; host syncs per "
          f"cycle {st['host_syncs_per_cycle']:.2f}; median cycle wall "
          f"{st['median_cycle_wall_s']} s; graph captures "
          f"{st['graph_captures']}, re-stages {st['graph_restages']}, "
          f"capture {st['capture_s']:.3f} s")


def sync_debug_group(pool, target, router_kw, prompts, new_tokens,
                     device) -> dict:
    """A session whose fourth cycle (cycle 0 per-op, 1 captures, 2
    replays) runs its one fused group under
    ``torch.cuda.set_sync_debug_mode("error")``: anything but the
    summary's wait that synchronises raises.  Returns the host syncs and
    fused groups that cycle counted (1 and 1)."""
    from repro_torch.core import ChainRouter
    router = ChainRouter(pool, target, device=device,
                         **dict(router_kw, profile_every=1000))
    n, L = prompts.shape
    sess = router.start_session(n, L + 2 * new_tokens + 32,
                                session_id="sync_debug")
    for s in range(n):
        sess.admit(s, prompts[s], new_tokens)
    for _ in range(3):
        sess.run_cycle()
    c = router.profiler.counters
    before = (c["host_sync"], c["groups.fused"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_sync_debug_mode("error")
    try:
        sess.run_cycle()
    except RuntimeError as e:
        raise PhaseFailed(f"a fused group synchronised outside its summary "
                          f"wait: {e}") from e
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(0)
    out = {"host_syncs": c["host_sync"] - before[0],
           "fused_groups": c["groups.fused"] - before[1],
           "sync_debug_mode": "error" if cuda else None}
    sess.close()
    if out["host_syncs"] != 1 or out["fused_groups"] != 1:
        raise PhaseFailed(f"a fused cycle of one group made {out}")
    return out


def phase_serving(device, cfgs, dtype=torch.bfloat16, n_prompts=4,
                  prompt_len=128, new_tokens=32, seed=0) -> dict:
    """Drive the port's main paths through their entry points.  Launch
    counters are zeroed just before each run and read just after."""
    from repro_torch.core import ChainRouter
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pool = build_pool(device, cfgs, dtype, seed)
    _sync(device)
    print(f"[time] serving pool built in {time.perf_counter() - t0:.1f} s")
    names = tuple(c.name for c in cfgs)
    target = names[-1]
    prompts = _prompts(n_prompts, prompt_len, cfgs[-1].vocab_size, seed)
    plens = np.full(n_prompts, prompt_len)
    options = serving_runs(names)
    for label in PER_OP_TWINS:
        options[label + "_per_op"] = dict(options[label], fused=False)
    runs, outs = {}, {}

    def run(label, fn):
        ops.reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        wall = time.perf_counter() - t0
        runs[label] = {"wall_s": wall, "launches": ops.launch_counts()}
        return out

    for label, kw in options.items():
        router = ChainRouter(pool, target, device=device, **kw)
        outs[label] = run(label, lambda: router.generate(
            prompts, plens, new_tokens, request_id=label))
        runs[label].update(
            cycles=outs[label].steps, tokens=outs[label].committed_tokens,
            chains=sorted({"->".join(c) for c, _ in
                           outs[label].chain_history}),
            fused=fused_stats(router, outs[label].cycle_wall_s))
        _print_fused(label, runs[label]["fused"])
        if kw.get("fused", True) and runs[label]["fused"]["groups_fused"] \
                <= 0:
            raise PhaseFailed(f"{label}: no group ran fused")
        if label == "fixed_chain":
            sess_outs, sess_cycles = run("session", lambda: _session_run(
                pool, target, prompts, new_tokens, device))
            runs["session"].update(
                cycles=sess_cycles,
                tokens=int(sum(len(o) for o in sess_outs)))
    sync_debug = {label: sync_debug_group(pool, target, options[label],
                                          prompts, new_tokens, device)
                  for label in PER_OP_TWINS}
    print(f"[fused] one fused group under sync debug mode: {sync_debug}")
    for label, rec in runs.items():
        rec["tokens_per_s"] = rec["tokens"] / rec["wall_s"]
        print(f"[serving] {label}: {rec['tokens']} tokens in "
              f"{rec['wall_s']:.3f} s ({rec['tokens_per_s']:.1f} tok/s), "
              f"{rec['cycles']} cycles, chains {rec.get('chains', '-')}, "
              f"launches {rec['launches']}")
    streams = [g for o in outs.values() for g in o.generated] + sess_outs
    lengths_ok = all(len(g) == new_tokens for g in streams)
    in_vocab = all(int(g.min()) >= 0 and int(g.max()) < cfgs[-1].vocab_size
                   for g in streams)
    fixed = outs["fixed_chain"]
    same = {label: [bool(np.array_equal(a, b)) for a, b in
                    zip(outs[label].generated, fixed.generated)]
            for label in outs if label != "fixed_chain"}
    same["session"] = [bool(np.array_equal(sess_outs[i], fixed.generated[i]))
                       for i in range(3)]
    print(f"[serving] streams equal to the fixed-chain streams: {same} "
          f"({_dtname(dtype)}; exact equality is checked in fp32)")
    totals = {k: sum(r["launches"][k] for r in runs.values())
              for k in ops.launch_counts()}
    t0 = time.perf_counter()
    profiles = ({label: _profile_generate(
        pool, target, options[label], prompts, plens, new_tokens, device,
        runs[label]["wall_s"], label) for label in PROFILED}
        if cuda else None)
    print(f"[time] profiled runs: {time.perf_counter() - t0:.1f} s")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    print(f"[serving] launches on the main paths: {totals}; peak memory "
          f"{peak if peak is None else f'{peak:.2f} GiB'}")
    if not (lengths_ok and in_vocab):
        raise PhaseFailed("serving produced streams of the wrong length or "
                          "out-of-vocabulary tokens")
    if cuda:
        missing = [f"{label}: {k}" for label, need in RUN_NEEDS.items()
                   for k in need if runs[label]["launches"][k] <= 0]
        if missing:
            raise PhaseFailed(f"kernels never launched on their path: "
                              f"{missing}")
    return {"runs": runs, "launches": totals, "peak_gib": peak,
            "stream_equal_to_fixed_chain": same, "profile": profiles,
            "sync_debug": sync_debug}


KERNEL_CLASSES = (("attention", ("flash_decode_kernel", "combine_kernel")),
                  ("row_kernels", ("row_reduce_kernel", "row_softmax_kernel",
                                   "row_dtv_kernel")),
                  ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")))


def _device_events(prof, label) -> list:
    """(name, microseconds) of every device activity (kernels, copies,
    memsets) in the profiler's trace.  The trace is exported and read back
    as JSON: building ``prof.events()`` in Python takes over a minute per
    run at this size."""
    path = build.BUILD_DIR / f"trace_{label}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        trace = json.loads(path.read_text())
    finally:
        path.unlink()
    events = trace.get("traceEvents", trace) if isinstance(trace, dict) \
        else trace
    return [(e["name"], float(e.get("dur", 0.0))) for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _profile_generate(pool, target, router_kw, prompts, plens, new_tokens,
                      device, plain_wall_s, label):
    """One more ``generate`` of a phase-4 run under ``torch.profiler``:
    device time by kernel class and by kernel (not counted in the launch
    totals above).  The busy share divides that device time by the wall
    time of the same run without the profiler (``plain_wall_s``), since
    tracing slows the host."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ChainRouter
    router = ChainRouter(pool, target, device=device, **router_kw)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _sync(device)
        t0 = time.perf_counter()
        router.generate(prompts, plens, new_tokens, request_id="profiled")
        _sync(device)
        wall = time.perf_counter() - t0
    kernels = _device_events(prof, label)
    if not kernels:
        print("[serving] profile: the profiler recorded no device time; "
              "device busy share not measured")
        return None
    by_name: dict = {}
    for name, us in kernels:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, n + 1)
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3
    n_events = sum(n for _, n in by_name.values())
    classes = {c: 0.0 for c, _ in KERNEL_CLASSES}
    classes["other"] = 0.0
    for name, (t, _) in by_name.items():
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in name for k in keys)), "other")
        classes[cls] += t / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"profiled_wall_s": wall, "wall_s": plain_wall_s,
           "device_busy_ms": busy_ms, "device_activities": n_events,
           "busy_share": busy_ms / 1e3 / plain_wall_s, "class_ms": classes,
           "top": [{"kernel": k[:90], "ms": t / 1e3, "launches": n}
                   for k, (t, n) in top]}
    print(f"[serving] profile ({label}): device busy {busy_ms:.1f} ms "
          f"= {out['busy_share']:.1%} of the unprofiled {plain_wall_s:.3f} s "
          f"(profiled wall {wall:.3f} s); {n_events} kernels, copies and "
          f"memsets; by class ms "
          f"{({c: round(v, 1) for c, v in classes.items()})}")
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


def add_twin(pool, target: str) -> str:
    """Register a twin of ``target``: its parameter tensors (no more
    memory) under another name.  A chain through the twin has its drafts
    accepted, so tree cycles keep nodes, linear cycles keep tokens and the
    contiguous state leaks the dead branches' holes."""
    cfg = dataclasses.replace(pool.cfg(target), name=target + "-twin")
    pool.register(cfg, params=pool.params(target))
    return cfg.name


def _twin_session(pool, names, twin, prompts, new_tokens, device,
                  fused=True):
    """A contiguous session whose rows hold little more than prompt and
    budget: slots 0, 1 and 3 (admitted mid-flight) run the 2x2x1 tree
    through the twin, slot 2 a window-4 linear chain draft -> twin ->
    target.  The shared write pointer outruns the rows every few cycles,
    so the capacity guard has to defragment.  Returns the streams, the
    per-slot committed tokens per active cycle and the defragment count."""
    from repro_torch.core import ChainRouter
    target = names[-1]
    router = ChainRouter(pool, target, adaptive=True, paged=False,
                         fused=fused, tree_shapes=(str(TREE),),
                         device=device)
    n, L = prompts.shape
    sess = router.start_session(
        num_slots=n, max_len=L + new_tokens + router.max_block + 6,
        session_id="twin_session")
    pins = {s: dict(chain=(twin, target), tree=str(TREE)) for s in range(n)}
    pins[2] = dict(chain=(names[0], twin, target), window=4)
    for s in range(n - 1):
        sess.admit(s, prompts[s], new_tokens, **pins[s])
    reports = [sess.run_cycle() for _ in range(2)]
    sess.admit(n - 1, prompts[n - 1], new_tokens, **pins[n - 1])
    while sess.active.any() and len(reports) < 4 * new_tokens + 16:
        reports.append(sess.run_cycle())
    commits = np.stack([r.commits for r in reports])
    per_cycle = [float(commits[:, s].sum() / max((commits[:, s] > 0).sum(),
                                                 1)) for s in range(n)]
    outs = [sess.retire(s) for s in range(n)]
    sess.close()
    return outs, per_cycle, router.states.defrag_count


OUTPUT_PATHS = ("fixed_chain", "paged_tree", "contiguous_linear",
                "contiguous_tree", "twin_paged_tree",
                "twin_contiguous_session")


def phase_output(device, cfgs, n_prompts=4, prompt_len=128, new_tokens=32,
                 seed=0, tie_gap=1e-3) -> dict:
    """Each speculative path of ``OUTPUT_PATHS`` against target-only greedy
    on the same fp32 weights: the chain of all three models (window 4 or
    the 2x2x1 tree, paged or contiguous), the 2x2x1 tree through a twin of
    the target (paged, ``generate``), and a contiguous session through the
    twin (``_twin_session``), each fused and per-op.  The twin paths must
    keep drafts (more than one token per cycle), the session must
    defragment and every fused path must run groups fused.  Verify blocks,
    tree levels and single-token steps use different GEMM shapes, so a
    divergence is accepted only at a near-tie of the target (top-2 logit
    gap < ``tie_gap``)."""
    from repro_torch.core import ChainRouter
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pool = build_pool(device, cfgs, torch.float32, seed)
    names = tuple(c.name for c in cfgs)
    target = names[-1]
    twin = add_twin(pool, target)
    prompts = _prompts(n_prompts, prompt_len, cfgs[-1].vocab_size, seed)
    plens = np.full(n_prompts, prompt_len)
    ref = ChainRouter(pool, target, adaptive=False, fixed_chain=(target,),
                      fixed_window=1, fused=False, device=device).generate(
                          prompts, plens, new_tokens, request_id="ref")
    options = serving_runs(names)
    options["twin_paged_tree"] = dict(adaptive=False,
                                      fixed_chain=(twin, target),
                                      fixed_tree=str(TREE))
    results = {}
    for path in OUTPUT_PATHS:
        streams = {}
        for fused in (True, False):
            name = path if fused else path + "_per_op"
            results[name], streams[fused] = _output_path(
                pool, names, twin, target, path, options, fused, prompts,
                plens, new_tokens, ref, tie_gap, device)
        same = sum(np.array_equal(a, b)
                   for a, b in zip(streams[True], streams[False]))
        results[path]["identical_rows_fused_vs_per_op"] = int(same)
        print(f"[output] fp32 {path}: fused and per-op identical on "
              f"{same}/{n_prompts} rows")
    return results


def _output_path(pool, names, twin, target, path, options, fused, prompts,
                 plens, new_tokens, ref, tie_gap, device):
    """One path of phase 5, fused or per-op, against target-only greedy:
    (its record, its streams)."""
    from repro_torch.core import ChainRouter
    n_prompts, prompt_len = prompts.shape
    name = path if fused else path + "_per_op"
    t0 = time.perf_counter()
    groups_fused = None
    if path == "twin_contiguous_session":
        streams, per_cycle, defrags = _twin_session(
            pool, names, twin, prompts, new_tokens, device, fused=fused)
        extra = {"commits_per_active_cycle": per_cycle,
                 "defragments": defrags}
        kept = min(per_cycle) > 1.0 and defrags > 0
    else:
        router = ChainRouter(pool, target, device=device,
                             **dict(options[path], fused=fused))
        spec = router.generate(prompts, plens, new_tokens, request_id=path)
        streams = spec.generated
        groups_fused = int(router.profiler.counters["groups.fused"])
        extra = {"cycles": {"speculative": spec.steps,
                            "target_only": ref.steps},
                 "groups_fused": groups_fused}
        kept = spec.steps < ref.steps
    divergences = []
    for b in range(n_prompts):
        got, want = streams[b], ref.generated[b]
        if np.array_equal(got, want):
            continue
        n = min(len(got), len(want))
        pos = int(np.argmax(got[:n] != want[:n])) if \
            np.any(got[:n] != want[:n]) else n
        gap = _top2_gap(pool, target,
                        ref.sequences[b][:prompt_len + pos], device)
        divergences.append({"row": b, "position": pos, "top2_gap": gap})
        print(f"[output] {name} row {b} diverges at generated position "
              f"{pos}: target top-2 logit gap {gap:.3e} (tolerated "
              f"below {tie_gap})")
        if gap >= tie_gap:
            raise PhaseFailed(
                f"{name}: speculative output differs from target-only "
                f"greedy at row {b} position {pos} without a near-tie "
                f"(gap {gap:.3e})")
    print(f"[output] fp32 {name} vs target-only: "
          f"{n_prompts - len(divergences)}/{n_prompts} rows identical, "
          f"{extra} ({time.perf_counter() - t0:.1f} s)")
    if path.startswith("twin") and not kept:
        raise PhaseFailed(f"{name}: the twin's drafts were not kept or "
                          f"the session never defragmented: {extra}")
    if fused and groups_fused == 0:
        raise PhaseFailed(f"{name}: no group ran fused")
    return ({"identical_rows": n_prompts - len(divergences),
             "rows": n_prompts, "divergences": divergences, **extra},
            streams)


# ---------------------------------------------------------------------------
REPRESENTATIVE = {"paged_attention": "llama-2-7b T=5 bfloat16",
                  "verify_stats": "R=20 V=32000 float32",
                  "softmax_stats": "R=4 V=32000 float32",
                  "dtv": "R=4 V=32000 float32",
                  "masked_decode_attention": "llama-2-7b T=1 S=256 bfloat16",
                  "masked_tree_attention": "llama-2-7b T=5 S=256 bfloat16",
                  "draft_topk": "R=16 V=32000 k=2 float32"}


def kernels_line(records, launches) -> list:
    """One entry per kernel at its representative main-path case (bf16
    attention as served; fp32 logits for the row reductions and the
    top-k).  ``launches`` counts standalone launches; the softmax
    statistics also run as pass 1 of every ``dtv`` launch, which its
    ``in_dtv_launches`` gives."""
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
        if name == "softmax_stats":
            out[-1]["in_dtv_launches"] = launches["dtv"]
    return out


def never_launched(launches) -> list:
    """Kernels that the main path never ran: no launch of their own, and
    for the softmax statistics no ``dtv`` launch either."""
    return [k for k, n in launches.items() if n <= 0 and not (
        k == "softmax_stats" and launches["dtv"] > 0)]


def main() -> int:
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"[time] phase {name}: {phase_s[name]:.1f} s")
        return out

    try:
        dev = timed("device", phase_device)
        build_s = timed("build", phase_build, "cuda")
        records = timed("kernels", phase_kernels, "cuda")
        floor = kernel_floor("cuda")
        host = host_cost("cuda")
        print(f"[kernels] host cost: median us per call over 1000 calls "
              f"(V=32000, a sync every 100 calls): {host}")
        from repro_torch.configs import llama_pool
        chain = llama_pool.full_pool()[:3]
        serving = timed("serving", phase_serving, "cuda", chain)
        gc.collect()
        torch.cuda.empty_cache()
        output = timed("output", phase_output, "cuda", chain)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    missing = never_launched(serving["launches"])
    if missing:
        print(f"chip_smoke: FAILED: kernels never launched on the main path: "
              f"{missing}", file=sys.stderr)
        return 1
    line = kernels_line(records, serving["launches"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": dev, "build_s": build_s, "phase_s": phase_s,
         "ptxas": ptxas_report(), "cases": records, "floor": floor,
         "host_us_per_call": host,
         "serving": serving, "output": output, "kernels": line}, indent=1))
    print(f"[device] {dev['smi']}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
