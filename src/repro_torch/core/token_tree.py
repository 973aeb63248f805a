"""Static token-tree shapes for tree-structured speculation (SpecInfer-style).

A ``TokenTree`` describes the *shape* of one speculative cycle's draft
tree: ``branching[d]`` children are drafted at depth ``d`` for every
parent at depth ``d-1`` (``branching[0]`` roots expand the last committed
token).  The shape is static per ``ChainChoice`` so every program
specializes on it once.  Nodes are numbered level by level (BFS, parent-major), so the
``j``-th node at depth ``d`` is the ``(j % branching[d])``-th child of the
``(j // branching[d])``-th node at depth ``d-1``.

The linear speculation window is exactly the branching-factor-1 special
case: ``TokenTree.linear(W) == TokenTree((1,) * W)`` is a chain of ``W``
nodes, and every tree-mode code path degenerates to the linear one.

Derived static arrays (all numpy, converted to device tensors by the
programs that consume them):

  parent   (N,)    parent node id, -1 for the roots (children of t_last)
  depth    (N,)    0-based node depth
  attend   (N, N)  ancestor-or-self mask: ``attend[i, j]`` iff node ``j``
                   is on the root path of node ``i`` (incl. ``i`` itself).
                   This is the mask the attention kernels consume for the
                   tree block (see ``layers.overlay_block_mask``).
  paths    (L, D)  node ids along each root->leaf path (L = #leaves)
  children (N+1, max_b)  children of each *logit row*: row 0 is the
                   verification bonus row (t_last -> roots), row i+1 holds
                   node i's children; -1 padded.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenTree:
    branching: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.branching) >= 1, "tree needs at least one level"
        assert all(int(b) >= 1 for b in self.branching), self.branching
        object.__setattr__(self, "branching",
                           tuple(int(b) for b in self.branching))

    # ---- identity ------------------------------------------------------
    @staticmethod
    def linear(window: int) -> "TokenTree":
        return TokenTree((1,) * int(window))

    @property
    def is_linear(self) -> bool:
        return all(b == 1 for b in self.branching)

    @property
    def depth_levels(self) -> int:
        """Tree depth D — the longest commit a cycle can make (plus bonus)."""
        return len(self.branching)

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        sizes, n = [], 1
        for b in self.branching:
            n *= b
            sizes.append(n)
        return tuple(sizes)

    @property
    def level_offsets(self) -> Tuple[int, ...]:
        offs, acc = [], 0
        for s in self.level_sizes:
            offs.append(acc)
            acc += s
        return tuple(offs)

    @property
    def num_nodes(self) -> int:
        return sum(self.level_sizes)

    @property
    def num_leaves(self) -> int:
        return self.level_sizes[-1]

    # ---- derived structure (cached via __dict__-free lru on id) --------
    def _build(self):
        sizes, offs = self.level_sizes, self.level_offsets
        N, D = self.num_nodes, self.depth_levels
        parent = np.full(N, -1, np.int32)
        depth = np.zeros(N, np.int32)
        for d in range(D):
            for j in range(sizes[d]):
                i = offs[d] + j
                depth[i] = d
                if d > 0:
                    parent[i] = offs[d - 1] + j // self.branching[d]
        attend = np.zeros((N, N), bool)
        for i in range(N):
            j = i
            while j >= 0:
                attend[i, j] = True
                j = int(parent[j])
        paths = np.zeros((sizes[-1], D), np.int32)
        for leaf_j in range(sizes[-1]):
            i = offs[-1] + leaf_j
            for d in range(D - 1, -1, -1):
                paths[leaf_j, d] = i
                i = int(parent[i])
        max_b = max(self.branching)
        children = np.full((N + 1, max_b), -1, np.int32)
        for i in range(N):
            p = int(parent[i]) + 1          # logit-row coordinates
            # children are filled in node order -> sibling-rank order
            for s in range(max_b):
                if children[p, s] < 0:
                    children[p, s] = i
                    break
        return parent, depth, attend, paths, children

    @property
    def parent(self) -> np.ndarray:
        return self._cached()[0]

    @property
    def depth(self) -> np.ndarray:
        return self._cached()[1]

    @property
    def attend(self) -> np.ndarray:
        return self._cached()[2]

    @property
    def paths(self) -> np.ndarray:
        return self._cached()[3]

    @property
    def children(self) -> np.ndarray:
        return self._cached()[4]

    def _cached(self):
        c = _STRUCT_CACHE.get(self.branching)
        if c is None:
            c = self._build()
            _STRUCT_CACHE[self.branching] = c
        return c

    # ---- convenience ---------------------------------------------------
    def level_nodes(self, d: int) -> np.ndarray:
        o = self.level_offsets[d]
        return np.arange(o, o + self.level_sizes[d], dtype=np.int32)

    def level_attend(self, d: int) -> np.ndarray:
        """Ancestor mask for drafting level ``d``: rows are the level's
        nodes, columns every node of depth <= d (the tree slots written so
        far plus the level itself)."""
        o, n = self.level_offsets[d], self.level_sizes[d]
        return self.attend[o:o + n, :o + n]

    def __str__(self) -> str:
        return "x".join(str(b) for b in self.branching)

    @staticmethod
    def parse(spec) -> "TokenTree":
        """'2x2x1' / '2,2,1' / (2, 2, 1) -> TokenTree((2, 2, 1))."""
        if isinstance(spec, TokenTree):
            return spec
        if isinstance(spec, (tuple, list)):
            return TokenTree(tuple(int(b) for b in spec))
        s = str(spec).replace(",", "x").replace("-", "x")
        return TokenTree(tuple(int(b) for b in s.split("x") if b))


_STRUCT_CACHE: dict = {}
