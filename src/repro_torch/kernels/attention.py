"""Paged flash-decode attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``repro/kernels/attention.py:paged_flash_decode_pallas`` (TPU
body ``_paged_attn_kernel``).  The kernel is hand-written CUDA C++ for
sm_90a (``repro_torch/csrc/paged_attention.cu``), built with ``nvcc`` at
first use and called through ``ctypes``.  What bounds it on the H100 and
what its design does about it is written at the top of that source: it is
memory-bound on the K/V blocks a row attends to, stages each 32-key K/V
chunk once per (row, KV head) CTA for all of that head's query rows, skips
chunks no query attends to, and reads the block table itself instead of a
gathered per-row view.

Semantics kept from the TPU wrapper (``ops.paged_decode_attention``):
scores are scaled by the true head dim, unallocated table entries (-1) are
clamped to a real block and never reach the softmax because their mask
columns are False, and fully masked query rows return 0.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..models.layers import gqa_attention
from .build import LaunchCounter, load_cuda_library

COUNTER = LaunchCounter("paged_attention")
SOURCE = "src/repro_torch/csrc/paged_attention.cu"
HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = load_cuda_library("paged_attention.cu")
        fn = lib.paged_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    if q.dtype not in _DTYPE_CODE or k_flat.dtype != q.dtype \
            or v_flat.dtype != q.dtype:
        raise TypeError(f"paged attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k_flat.dtype}/"
                        f"{v_flat.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged attention kernel supports head dims "
                         f"{HEAD_DIMS}, got {D}")
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
