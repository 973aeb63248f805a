"""Total variation distance over a large vocabulary (paper Eq. 5): the CUDA
kernels' wrappers and their plain PyTorch versions.

Softmax statistics (``softmax_stats_cuda``).  Replaces
``repro/kernels/dtv.py:softmax_stats`` (TPU body ``_stats_kernel``): per
row, (max, sumexp rescaled to the max) in one read of the row.

DTV (``dtv_cuda``).  Replaces ``repro/kernels/dtv.py:dtv_pallas`` (TPU body
``_dtv_kernel``, after two ``softmax_stats`` calls): per row pair,
``0.5·Σ|softmax(a) − softmax(b)|`` in one launch.  The SimScore probe
(``core/chain_router.py:probe_dtv_rows``) compares chain members'
last-token logits with it without materializing probabilities.

Both are hand-written CUDA C++ for sm_90a on the vocabulary-row body of
``csrc/row_reduce.cuh`` (entry points in ``csrc/row_kernels.cu``, built
with ``nvcc`` at first use and called through ``ctypes``).  What bounds
them on the H100: one read of the logits (1 or 4 rows of V = 32000 in the
probe, up to 262144 in the repository's configurations).  Each row is cut
into C slices by ``verify.row_split_plan``, one CTA of a thread-block
cluster each.  DTV's two passes run in one cluster: the normalizers meet
through distributed shared memory, and pass 2 reads the slices from
registers where a CTA's slice is one batch per thread (the probe's
V = 32000), else once more from L2.

``dtv_probs`` is the probability-domain definition shared by verification.
"""
from __future__ import annotations

import torch

from .build import LaunchCounter
from .verify import launch_args, launcher, rows_of

STATS_COUNTER = LaunchCounter("softmax_stats")
DTV_COUNTER = LaunchCounter("dtv")
SOURCE = "src/repro_torch/csrc/row_kernels.cu"


def dtv_probs(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """0.5 · Σ_v |p − q| over the last axis (paper Eq. 5), probability
    domain."""
    return 0.5 * torch.sum(torch.abs(p - q), dim=-1)


def softmax_stats_plain(logits: torch.Tensor):
    """(R, V) -> (max (R,), sumexp (R,)) f32 — ``ref.softmax_stats_ref``."""
    x = logits.float()
    m = x.max(dim=-1).values
    return m, torch.exp(x - m[:, None]).sum(dim=-1)


def dtv_plain(a_logits: torch.Tensor, b_logits: torch.Tensor) -> torch.Tensor:
    """(R, V) x2 -> (R,) f32 — ``ref.dtv_ref``."""
    return dtv_probs(torch.softmax(a_logits.float(), dim=-1),
                     torch.softmax(b_logits.float(), dim=-1))


def _pair_rows(logits: torch.Tensor) -> tuple:
    """(R, V, row stride) of (R, V) rows with unit column stride, float32
    or bfloat16."""
    if logits.dim() != 2:
        raise ValueError(f"expected (R, V) logits, got shape "
                         f"{tuple(logits.shape)}")
    R, V, _, _, st = rows_of(logits)
    return R, V, st


def softmax_stats_cuda(logits: torch.Tensor):
    """Launch the softmax-statistics kernel on torch's current stream (same
    result as ``softmax_stats_plain``)."""
    R, V, st = _pair_rows(logits)
    m, s = torch.empty((2, R), dtype=torch.float32,
                       device=logits.device).unbind(0)
    err = launcher("row_softmax_stats_launch")(
        logits.data_ptr(), m.data_ptr(), s.data_ptr(), R, V, st,
        *launch_args(logits, R, V))
    if err != 0:
        raise RuntimeError(f"row_softmax_stats_launch failed: cudaError "
                           f"{err}")
    STATS_COUNTER.count += 1
    return m, s


def dtv_cuda(a_logits: torch.Tensor, b_logits: torch.Tensor) -> torch.Tensor:
    """Eq. 5 in the logits domain in one launch on torch's current stream,
    replacing the TPU's ``dtv_pallas`` and its two ``softmax_stats`` calls
    (same result as ``dtv_plain``).  The two (R, V) inputs may have
    different row strides."""
    if (a_logits.shape != b_logits.shape or a_logits.dtype != b_logits.dtype
            or a_logits.device != b_logits.device):
        raise ValueError(
            f"dtv rows differ: {tuple(a_logits.shape)} {a_logits.dtype} on "
            f"{a_logits.device} vs {tuple(b_logits.shape)} {b_logits.dtype} "
            f"on {b_logits.device}")
    R, V, sa = _pair_rows(a_logits)
    _, _, sb = _pair_rows(b_logits)
    C, per, dtype, stream = launch_args(a_logits, R, V)
    out = torch.empty(R, dtype=torch.float32, device=a_logits.device)
    err = launcher("row_dtv_launch")(
        a_logits.data_ptr(), b_logits.data_ptr(), out.data_ptr(), R, V, sa,
        sb, C, per, dtype, stream)
    if err != 0:
        raise RuntimeError(f"row_dtv_launch failed: cudaError {err}")
    DTV_COUNTER.count += 1
    return out
