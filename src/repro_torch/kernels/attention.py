"""Flash-decode attention kernels: the CUDA kernels' wrappers and their
plain PyTorch versions.

- ``paged_attention``: replaces ``repro/kernels/attention.py:
  paged_flash_decode_pallas`` (TPU body ``_paged_attn_kernel``), over the
  paged state's block pool (``csrc/paged_attention.cu``);
- ``masked_decode_attention``: replaces ``masked_decode_attention_pallas``
  (``_attn_kernel``), one query token over a contiguous cache;
- ``masked_tree_attention``: replaces ``masked_tree_attention_pallas``
  (``_tree_attn_kernel``), T query tokens with per-query mask rows over a
  contiguous cache (both in ``csrc/masked_attention.cu``).

All three are hand-written CUDA C++ for sm_90a on one shared kernel body
(``csrc/flash_decode.cuh``), built with ``nvcc`` at first use and called
through ``ctypes``.  What bounds them on the H100 and what the design does
about it is written at the top of those sources: they are memory-bound on
the K/V a row attends to; a CTA stages each 32-key K/V chunk once for all
the query rows of one (row, KV head) and skips chunks no query attends
to.  The paged kernel reads the block table itself; the contiguous ones
address the cache with an identity table and cut the last chunk at S.

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
    [table,] mask, out), ``n_ints`` ints, the scale, the dtype code and the
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
    return _bind("paged_attention.cu", "paged_attention_launch", 6, 8)


def masked_launchers():
    """(decode launcher, tree launcher) of ``csrc/masked_attention.cu``."""
    return (_bind("masked_attention.cu", "masked_decode_attention_launch",
                  5, 5),
            _bind("masked_attention.cu", "masked_tree_attention_launch",
                  5, 6))


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
    P = k_flat.shape[0] // block_size
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(),
                      table.data_ptr(), mask.data_ptr(), out.data_ptr(),
                      B, T, H, Hkv, D, P, block_size, R,
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ints = (B, H, Hkv, D, S) if decode else (B, T, H, Hkv, D, S)
    err = launcher(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                   out.data_ptr(), *ints, 1.0 / math.sqrt(D),
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
