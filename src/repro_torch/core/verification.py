"""Linear greedy verification (``repro.core.verification``, paper §2.2
step 3, §4.3 VerifyProcessor).

Protocol invariant (every model in the chain):
  - a model's committed cache EXCLUDES the most recent committed token
    ``t_last``;
  - a verify pass feeds ``[t_last, c_0, …, c_{T-1}]`` and gets logits
    ``l_0 … l_T`` where ``l_i`` verifies ``c_i`` and ``l_T`` is the bonus
    position;
  - after accepting ``k`` tokens the model commits ``t_last, c_0…c_{k-1}``,
    the correction/bonus becomes the new ``t_last``, and the state rolls
    back by ``r = T - k`` (paper Eq. 8/9).

Greedy: accept iff candidate == argmax(verifier logits); the output stream
is bit-identical to target-only greedy decoding (paper §5).  The argmax
and the softmax normalizers come from one pass of the verify-stats kernel
(``ops.verify_row_stats``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import ops
from ..kernels.dtv import dtv_probs


class VerifyResult(NamedTuple):
    num_accepted: torch.Tensor   # (B,) int32 — k, accepted candidate prefix
    next_token: torch.Tensor     # (B,) int32 — correction (k<T) or bonus (k=T)
    next_probs: torch.Tensor     # (B, V) — verifier distribution at row k
    rollback: torch.Tensor       # (B,) int32 — r = T - k
    dtv: torch.Tensor            # (B,) float32 — mean TV distance p vs q


def verify_greedy(candidates: torch.Tensor, verifier_logits: torch.Tensor,
                  candidate_probs: Optional[torch.Tensor] = None,
                  active: Optional[torch.Tensor] = None) -> VerifyResult:
    """candidates: (B, T); verifier_logits: (B, T+1, V).

    candidate_probs (B, T, V) is optional — used only for the DTV metric.
    active (B,) masks finished rows (their result is a no-op)."""
    B, T = candidates.shape
    V = verifier_logits.shape[-1]
    rows = verifier_logits.reshape(B * (T + 1), V)
    cand_rows = torch.cat(
        [candidates, candidates.new_zeros((B, 1))], dim=1).reshape(-1)
    am, m, s, _ = ops.verify_row_stats(rows, cand_rows)
    preds = am.reshape(B, T + 1).long()
    match = preds[:, :T] == candidates.long()
    k = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    next_token = torch.gather(preds, 1, k[:, None])[:, 0]
    # probabilities from the kernel's (max, sumexp): no second softmax pass
    m = m.reshape(B, T + 1, 1)
    s = s.reshape(B, T + 1, 1)
    at_k = torch.arange(B, device=rows.device) * (T + 1) + k
    next_probs = (torch.exp(rows[at_k].float() - m.reshape(-1, 1)[at_k])
                  / s.reshape(-1, 1)[at_k])
    if candidate_probs is not None:
        p = torch.exp(verifier_logits[:, :T].float() - m[:, :T]) / s[:, :T]
        dtv = dtv_probs(p, candidate_probs.float()).mean(dim=-1)
    else:
        dtv = torch.zeros((B,), dtype=torch.float32, device=rows.device)
    r = T - k
    if active is not None:
        zero = torch.zeros_like(k)
        k = torch.where(active, k, zero)
        r = torch.where(active, r, zero)      # inactive rows appended nothing
        next_token = torch.where(active, next_token, zero)
    return VerifyResult(k.to(torch.int32), next_token.to(torch.int32),
                        next_probs, r.to(torch.int32), dtv)


def consensus_rollbacks(ks_arr: torch.Tensor, window: int,
                        active: torch.Tensor) -> torch.Tensor:
    """Per-level rollback lengths for a linear chain.

    ks_arr: (N-1, B) accepted counts per verify level; level j in
    [1..N-1] holds a candidate of length ``window + (j-1)`` and rolls back
    to min(k_j, …, k_N) (the paper's consensus).  Returns (N-1, B) int32."""
    n_lvls = ks_arr.shape[0]
    out = []
    for j in range(1, n_lvls + 1):
        tc_j = window + (j - 1)
        consensus = ks_arr[j - 1:].amin(dim=0)
        out.append(torch.where(active, tc_j - consensus.clamp(max=tc_j), 0))
    return torch.stack(out).to(torch.int32)


def splice_candidates(candidates: torch.Tensor,
                      candidate_probs: Optional[torch.Tensor],
                      res: VerifyResult
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                 torch.Tensor]:
    """Next level's candidate block from this level's outcome: accepted
    prefix ++ [correction/bonus] ++ padding (the correction repeated; in
    greedy mode positions past the first mismatch never commit).

    Returns (next_candidates (B, T+1), next_probs or None, valid_len (B,))."""
    B, T = candidates.shape
    k = res.num_accepted.to(candidates.device)
    idx = torch.arange(T + 1, dtype=torch.int32,
                       device=candidates.device)[None, :]
    cand_pad = torch.cat([candidates, candidates.new_zeros((B, 1))], dim=1)
    keep = idx < k[:, None]
    next_cand = torch.where(keep, cand_pad,
                            res.next_token.to(candidates)[:, None])
    valid_len = k + 1
    if candidate_probs is None:
        return next_cand, None, valid_len
    V = candidate_probs.shape[-1]
    probs_pad = torch.cat([candidate_probs,
                           candidate_probs.new_zeros((B, 1, V))], dim=1)
    next_probs = torch.where(keep[..., None], probs_pad,
                             res.next_probs[:, None, :].to(probs_pad))
    return next_cand, next_probs, valid_len
