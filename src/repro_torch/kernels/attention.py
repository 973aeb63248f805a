"""Flash-decode attention kernels: the CUDA kernels' wrappers, their
plain PyTorch versions and the key-split plan.

- ``paged_attention``: replaces ``repro/kernels/attention.py:
  paged_flash_decode_pallas`` (TPU body ``_paged_attn_kernel``), over the
  paged state's block pool (``csrc/paged_attention.cu``);
- ``masked_decode_attention``: replaces ``masked_decode_attention_pallas``
  (``_attn_kernel``), one query token over a contiguous cache;
- ``masked_tree_attention``: replaces ``masked_tree_attention_pallas``
  (``_tree_attn_kernel``), T query tokens with per-query mask rows over a
  contiguous cache (both in ``csrc/masked_attention.cu``).

All three are hand-written CUDA C++ for sm_90a on one kernel body
(``csrc/flash_decode.cuh``), built with ``nvcc`` at first use and called
through ``ctypes``.  They are bound by the bytes of the K/V a row attends
to, so the body is built to keep bytes in flight: ``split_plan`` cuts each
row's keys into chunk-aligned ranges so that several CTAs per (row, KV
head) fill the card, each CTA prefetches 32-key K/V chunks with 16-byte
``cp.async`` copies into a ring of shared-memory stages, skips chunks no
query of its tile attends to before copying them, and a second small
kernel merges the splits' fp32 partials in a fixed order (scratch from
``torch.empty`` here).  The plan reads no tensor and does not depend on T,
so the wrappers add no host sync and a query row is reduced in the same
order in a decode, a verify block and a tree block.

Semantics kept from the TPU wrappers (``ops.*_attention``): scores are
scaled by the true head dim, unallocated table entries (-1) are clamped to
a real block and never reach the softmax because their mask columns are
False, outputs have the unpadded shape, and fully masked query rows
return 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..device import sm_count
from ..models.layers import gqa_attention
from .build import LaunchCounter, load_cuda_library

COUNTER = LaunchCounter("paged_attention")
DECODE_COUNTER = LaunchCounter("masked_decode_attention")
TREE_COUNTER = LaunchCounter("masked_tree_attention")
SOURCE = "src/repro_torch/csrc/paged_attention.cu"
MASKED_SOURCE = "src/repro_torch/csrc/masked_attention.cu"
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fns: dict = {}


def _bind(source: str, symbol: str, n_ptrs: int, n_ints: int):
    """ctypes binding of a launcher: ``n_ptrs`` pointers (q, k, v,
    [table,] mask, out, split partials ml and acc), ``n_ints`` ints, the scale, the dtype code and the
    stream."""
    key = (source, symbol)
    if key not in _fns:
        fn = getattr(load_cuda_library(source), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def _launcher():
    return _bind("paged_attention.cu", "paged_attention_launch", 8, 10)


def masked_launchers():
    """(decode launcher, tree launcher) of ``csrc/masked_attention.cu``."""
    return (_bind("masked_attention.cu", "masked_decode_attention_launch",
                  7, 7),
            _bind("masked_attention.cu", "masked_tree_attention_launch",
                  7, 8))


CHUNK = 32        # keys per K/V chunk of the kernel (flash_decode.cuh kChunk)
WAVES = 4         # CTAs the plan aims for: this many per SM
ROW_TILES = (1, 2, 4, 5, 6, 8, 12, 16)   # query rows per CTA (launch_tiles)


def row_tile(n_rows: int) -> int:
    """Query rows per CTA for n_rows = T·g query rows per (row, KV head):
    the least tile that holds them, else the largest."""
    return next((t for t in ROW_TILES if n_rows <= t), ROW_TILES[-1])


def split_plan(B: int, Hkv: int, S: int, bs: int, n_sm: int) -> tuple:
    """Key splits of one launch: ``(splits, chunks per split)``.

    A row's S = R·bs key slots are cut into chunks of ``CHUNK`` slots from
    each block's start (the last one cut at the block's end); a split is a
    run of whole chunks.  The plan asks for ``WAVES·n_sm`` CTAs over the
    ``B·Hkv`` (row, KV head) pairs and takes one split when those pairs
    already give that many.  Row tiles (T·g) are no input, so a query row
    is reduced in the same order whatever the block it is launched in; the
    plan reads no tensor, so it costs no host sync.  Contiguous caches pass
    bs = S (one block per row)."""
    if min(B, Hkv, S, bs, n_sm) <= 0 or S % bs:
        raise ValueError(f"bad split-plan inputs B={B} Hkv={Hkv} S={S} "
                         f"bs={bs} n_sm={n_sm}")
    n_chunks = (S // bs) * (-(-bs // CHUNK))
    want = -(-WAVES * n_sm // (B * Hkv))
    splits = max(1, min(want, n_chunks))
    per = -(-n_chunks // splits)
    return -(-n_chunks // per), per


def split_ranges(S: int, bs: int, splits: int, per: int) -> list:
    """The row-local key slots ``[lo, hi)`` of each split of a plan."""
    cpb = -(-bs // CHUNK)

    def start(c):
        return (c // cpb) * bs + (c % cpb) * CHUNK

    n_chunks = (S // bs) * cpb
    return [(start(i * per), start(min(n_chunks, (i + 1) * per)))
            for i in range(splits)]


def _plan_and_scratch(q: torch.Tensor, B: int, Hkv: int, S: int, bs: int):
    """Split plan for this launch and its fp32 partials, one buffer of
    (m, l) pairs then acc rows (null pointers for one split)."""
    splits, per = split_plan(B, Hkv, S, bs, sm_count(q.device))
    if splits == 1:
        return splits, per, 0, 0, None
    n = q.numel() // q.shape[-1] * splits
    scratch = torch.empty(n * (2 + q.shape[-1]), dtype=torch.float32,
                          device=q.device)
    ml = scratch.data_ptr()
    return splits, per, ml, ml + 2 * n * scratch.element_size(), scratch


def _check_aligned(what: str, *tensors: torch.Tensor) -> None:
    """The kernel copies K/V in 16-byte units: every operand it reads or
    writes that way must start on a 16-byte boundary."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} needs 16-byte aligned q/k/v/out")


def _check_dtypes(what: str, q, k, v) -> None:
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what} kernel supports head dims {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")


def paged_attention_plain(q: torch.Tensor, k_flat: torch.Tensor,
                          v_flat: torch.Tensor, block_table: torch.Tensor,
                          mask: torch.Tensor, block_size: int) -> torch.Tensor:
    """q: (B, T, H, D); k_flat, v_flat: (P·bs, Hkv, D); block_table (B, R)
    int, -1 = unallocated; mask: (B, T, R·bs) bool -> (B, T, H, D) in q's
    dtype.  Gathers each row's contiguous view through the block table
    (``ref.paged_attention_ref``), then runs the reference forward's
    masked GQA attention (``layers.gqa_attention``)."""
    R = block_table.shape[1]
    s = torch.arange(R * block_size, device=q.device)
    pid = block_table[:, s // block_size].long()                 # (B, S)
    flat = pid.clamp(min=0) * block_size + (s % block_size)[None, :]
    return gqa_attention(q, k_flat[flat], v_flat[flat], mask)


def paged_attention_cuda(q: torch.Tensor, k_flat: torch.Tensor,
                         v_flat: torch.Tensor, block_table: torch.Tensor,
                         mask: torch.Tensor, block_size: int) -> torch.Tensor:
    """Launch the CUDA kernel on torch's current stream (same arguments
    and result as ``paged_attention_plain``)."""
    B, T, H, D = q.shape
    Hkv = k_flat.shape[1]
    R = block_table.shape[1]
    _check_dtypes("paged attention", q, k_flat, v_flat)
    if H % Hkv or k_flat.shape != v_flat.shape or k_flat.shape[2] != D \
            or k_flat.shape[0] % block_size:
        raise ValueError(f"inconsistent shapes q{tuple(q.shape)} "
                         f"k{tuple(k_flat.shape)} v{tuple(v_flat.shape)} "
                         f"block_size={block_size}")
    if tuple(mask.shape) != (B, T, R * block_size) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool (B, T, R*bs) = "
                         f"{(B, T, R * block_size)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    tensors = (q, k_flat, v_flat, block_table, mask)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged attention operands must share one device")
    q = q.contiguous()
    k_flat = k_flat.contiguous()
    v_flat = v_flat.contiguous()
    table = block_table.to(torch.int32).contiguous()
    mask = mask.contiguous()
    out = torch.empty_like(q)
    _check_aligned("paged attention", q, k_flat, v_flat, out)
    P = k_flat.shape[0] // block_size
    splits, per, ml, acc, _keep = _plan_and_scratch(q, B, Hkv, R * block_size,
                                                    block_size)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(),
                      table.data_ptr(), mask.data_ptr(), out.data_ptr(),
                      ml, acc, B, T, H, Hkv, D, P, block_size, R, splits, per,
                      1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_launch failed: cudaError {err}")
    COUNTER.count += 1
    return out


def masked_tree_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """q: (B, T, H, D); k, v: (B, S, Hkv, D); mask: (B, T, S) bool ->
    (B, T, H, D) in q's dtype (``ref.masked_tree_attention_ref``)."""
    return gqa_attention(q, k, v, mask)


def masked_decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  mask: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k, v: (B, S, Hkv, D); mask: (B, S) bool -> (B, H, D)
    (``ref.masked_decode_attention_ref``: the T = 1 case)."""
    return gqa_attention(q[:, None], k, v, mask[:, None])[:, 0]


def _masked_cuda(what, launcher, counter, q, k, v, mask, T, decode):
    """Shared launch of the contiguous kernels; q is (B, T, H, D)-shaped
    memory, mask (B, T, S)-shaped (T = 1 for ``decode``, whose launcher
    takes no T)."""
    B, S, Hkv, D = k.shape
    H = q.shape[-2]
    _check_dtypes(what, q, k, v)
    if H % Hkv or k.shape != v.shape or q.shape[-1] != D \
            or q.shape[0] != B:
        raise ValueError(f"inconsistent shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if mask.dtype != torch.bool or mask.numel() != B * T * S \
            or mask.shape[0] != B or mask.shape[-1] != S:
        raise ValueError(f"mask must be bool with {B} rows of {T} x {S}, "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k and v must be contiguous (B, S, Hkv, D) caches")
    if any(t.device != q.device for t in (k, v, mask)):
        raise ValueError(f"{what} operands must share one device")
    q = q.contiguous()
    mask = mask.contiguous()
    out = torch.empty_like(q)
    _check_aligned(what, q, k, v, out)
    splits, per, ml, acc, _keep = _plan_and_scratch(q, B, Hkv, S, S)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ints = (B, H, Hkv, D, S) if decode else (B, T, H, Hkv, D, S)
    err = launcher(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                   out.data_ptr(), ml, acc, *ints, splits, per,
                   1.0 / math.sqrt(D),
                   _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
    counter.count += 1
    return out


def masked_decode_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Launch the contiguous decode kernel (same arguments and result as
    ``masked_decode_attention_plain``)."""
    if q.dim() != 3 or mask.dim() != 2:
        raise ValueError(f"decode attention takes q (B, H, D) and mask "
                         f"(B, S), got {tuple(q.shape)} / "
                         f"{tuple(mask.shape)}")
    return _masked_cuda("masked decode attention", masked_launchers()[0],
                        DECODE_COUNTER, q, k, v, mask, 1, decode=True)


def masked_tree_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Launch the contiguous tree-block kernel (same arguments and result
    as ``masked_tree_attention_plain``)."""
    if q.dim() != 4 or mask.dim() != 3 or mask.shape[1] != q.shape[1]:
        raise ValueError(f"tree attention takes q (B, T, H, D) and mask "
                         f"(B, T, S), got {tuple(q.shape)} / "
                         f"{tuple(mask.shape)}")
    return _masked_cuda("masked tree attention", masked_launchers()[1],
                        TREE_COUNTER, q, k, v, mask, q.shape[1],
                        decode=False)
