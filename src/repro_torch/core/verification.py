"""Greedy verification (``repro.core.verification``, paper §2.2 step 3,
§4.3 VerifyProcessor): linear candidate blocks and token trees.

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

Token trees (SpecInfer-style, one merged verify pass): a node is accepted
iff its token is the verifier's argmax at its parent's row and its whole
root path is accepted; the deepest accepted root-to-leaf prefix commits,
plus the correction/bonus token.  At most one child per node can match
the argmax, so the committed stream is again target-only greedy.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..kernels.dtv import dtv_probs


class TreeTensors(NamedTuple):
    """A tree shape's static arrays on one device, built once per (tree,
    device): a captured program may not upload from the host, and the
    per-op path need not upload them on every call."""
    parent_rows: torch.Tensor          # (N,) long: verify row of the parent
    attend: torch.Tensor               # (N, N) bool ancestor-or-self
    paths: torch.Tensor                # (L, D) long root->leaf node ids
    level_depth: Tuple[torch.Tensor, ...]   # per level (n_d,) int32 = d
    level_attend: Tuple[torch.Tensor, ...]  # per level (n_d, R_d) bool


@functools.lru_cache(maxsize=64)
def tree_tensors(tree, device: torch.device) -> TreeTensors:
    def up(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    D = tree.depth_levels
    return TreeTensors(
        up(tree.parent + 1, torch.long), up(tree.attend),
        up(tree.paths, torch.long),
        tuple(up(np.full(tree.level_sizes[d], d, np.int32))
              for d in range(D)),
        tuple(up(tree.level_attend(d)) for d in range(D)))


@functools.lru_cache(maxsize=64)
def tree_block_masks(tree, prefix_width: int, device: torch.device):
    """(spec_depth (G+N,) int32, spec_attend (G+N, N) bool) of a verify
    block ``[gap prefix of width G ++ the tree's N nodes]``: the prefix
    appends linearly, the nodes at their depths under the ancestor mask."""
    N = tree.num_nodes
    depth = np.concatenate([np.full(prefix_width, -1, np.int32),
                            tree.depth]).astype(np.int32)
    attend = np.concatenate([np.zeros((prefix_width, N), bool),
                             tree.attend])
    return (torch.as_tensor(depth, device=device),
            torch.as_tensor(attend, device=device))


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
    # the kernel reads the (B, T+1, V) rows in place, strided or not
    cand_rows = torch.cat([candidates, candidates.new_zeros((B, 1))], dim=1)
    am, m, s, _ = ops.verify_row_stats(verifier_logits, cand_rows)
    preds = am.long()
    match = preds[:, :T] == candidates.long()
    k = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    next_token = torch.gather(preds, 1, k[:, None])[:, 0]
    # probabilities from the kernel's (max, sumexp): no second softmax pass
    b = torch.arange(B, device=verifier_logits.device)
    next_probs = (torch.exp(verifier_logits[b, k].float() - m[b, k, None])
                  / s[b, k, None])
    if candidate_probs is not None:
        p = (torch.exp(verifier_logits[:, :T].float() - m[:, :T, None])
             / s[:, :T, None])
        dtv = dtv_probs(p, candidate_probs.float()).mean(dim=-1)
    else:
        dtv = torch.zeros((B,), dtype=torch.float32,
                          device=verifier_logits.device)
    r = T - k
    if active is not None:
        zero = torch.zeros_like(k)
        k = torch.where(active, k, zero)
        r = torch.where(active, r, zero)      # inactive rows appended nothing
        next_token = torch.where(active, next_token, zero)
    return VerifyResult(k.to(torch.int32), next_token.to(torch.int32),
                        next_probs, r.to(torch.int32), dtv)


class TreeVerifyResult(NamedTuple):
    """Outcome of verifying one token tree.  The verify pass feeds
    ``[gap…, t_last, node_0 … node_{N-1}]`` and keeps rows ``l_0 … l_N``:
    ``l_0`` verifies the roots, ``l_{i+1}`` is the distribution after node
    ``i`` (verifies its children, or is the bonus row)."""
    accept: torch.Tensor         # (B, N) bool — path-closed per-node accept
    num_accepted: torch.Tensor   # (B,) int32 — accepted depth k on the path
    path_nodes: torch.Tensor     # (B, D) int32 — winning root->leaf node ids
    next_token: torch.Tensor     # (B,) int32 — correction (k<D) / bonus
    next_probs: torch.Tensor     # (B, V) — distribution of next_token's row
    dtv: torch.Tensor            # (B,) float32 — mean TV p vs q over nodes


def _path_closure(attend: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """accept[b, i] = every ancestor-or-self of node i matched; ``attend``
    is the tree's static (N, N) ancestor-or-self matrix."""
    return (~attend[None] | match[:, None, :]).all(dim=-1)


def _best_path(paths: torch.Tensor, accept: torch.Tensor):
    """(L, D) static paths + (B, N) accept -> (k (B,), path_nodes (B, D)):
    the deepest accepted root-to-leaf prefix, ties to the first leaf."""
    acc_on_path = accept[:, paths].to(torch.int32)              # (B, L, D)
    depth_acc = torch.cumprod(acc_on_path, dim=-1).sum(dim=-1)  # (B, L)
    k, best_leaf = depth_acc.max(dim=-1)                        # first max
    return k.to(torch.int32), paths[best_leaf]


def verify_tree(tree, candidates: torch.Tensor,
                verifier_logits: torch.Tensor, node_valid: torch.Tensor,
                candidate_probs: Optional[torch.Tensor] = None,
                active: Optional[torch.Tensor] = None) -> TreeVerifyResult:
    """Greedy tree verification.  candidates (B, N) node tokens in tree
    order; verifier_logits (B, N+1, V) per the TreeVerifyResult rows;
    node_valid (B, N) — False for nodes an earlier chain level pruned
    (force-rejected); candidate_probs (B, N, V) each node's producer
    distribution, used only for the DTV metric; active (B,) masks rows
    that sat the cycle out."""
    B, N = candidates.shape
    D = tree.depth_levels
    dev = candidates.device
    parent_rows, attend, paths, _, _ = tree_tensors(tree, dev)
    am, m, s, _ = ops.verify_row_stats(
        verifier_logits, torch.zeros((B, N + 1), dtype=torch.int32,
                                     device=dev))
    preds = am.long()
    match = (candidates.long() == preds[:, parent_rows]) & node_valid
    accept = _path_closure(attend, match)
    k, path_nodes = _best_path(paths, accept)
    last = torch.gather(path_nodes, 1,
                        (k.long() - 1).clamp(0, D - 1)[:, None])[:, 0]
    pos = torch.where(k > 0, last + 1, 0)                       # bonus row
    next_token = torch.gather(preds, 1, pos[:, None])[:, 0]
    b = torch.arange(B, device=dev)
    next_probs = (torch.exp(verifier_logits[b, pos].float() - m[b, pos, None])
                  / s[b, pos, None])
    if candidate_probs is not None:
        mp = m[:, parent_rows, None]
        sp = s[:, parent_rows, None]
        p_par = torch.exp(verifier_logits[:, parent_rows].float() - mp) / sp
        d = dtv_probs(p_par, candidate_probs.float())            # (B, N)
        nv = node_valid.float()
        dtv = (d * nv).sum(dim=-1) / nv.sum(dim=-1).clamp(min=1.0)
    else:
        dtv = torch.zeros((B,), dtype=torch.float32, device=dev)
    if active is not None:
        k = torch.where(active, k, 0)
        next_token = torch.where(active, next_token, 0)
        accept = accept & active[:, None]
    return TreeVerifyResult(accept, k.to(torch.int32),
                            path_nodes.to(torch.int32),
                            next_token.to(torch.int32), next_probs, dtv)


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


def tree_consensus_keep(accepts: Sequence[torch.Tensor],
                        path_nodes: torch.Tensor, k_n: torch.Tensor,
                        active: torch.Tensor) -> torch.Tensor:
    """Consensus keep-lengths for a tree cycle: chain position j keeps the
    winning-path prefix that it and every deeper level accepted (the draft
    at j = 0 keeps the min over all levels).  accepts: per verify level a
    (B, N) path-closed accept matrix; path_nodes (B, D) the target's
    winning path; k_n (B,) its accepted depth.  Returns (len(chain), B)
    int32, inactive rows 0."""
    counts = []
    for acc in accepts:
        onpath = torch.gather(acc.to(torch.int32), 1, path_nodes.long())
        counts.append(torch.minimum(torch.cumprod(onpath, dim=1).sum(dim=1),
                                    k_n.to(torch.int64)))
    carr = torch.stack(counts)                                   # (N-1, B)
    outs = [torch.where(active, carr[max(j - 1, 0):].amin(dim=0), 0)
            for j in range(len(accepts) + 1)]
    return torch.stack(outs).to(torch.int32)


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
