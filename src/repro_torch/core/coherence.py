"""Coherence graphs and the three P-model quality parameters (Defs. 2-4).

Port of ``repro.core.coherence``: the P_i matrices come from
``torch.func.jacfwd`` of ``materialize`` (on the params' device, brought
to the host), and everything after them is the reference's numpy.

chi[P]   — max chromatic number over all coherence graphs G_{i1,i2}
mu[P]    — coherence       max_{i,j} sqrt( sum_{n1<n2} sigma_{ij}(n1,n2)^2 / n )
mu~[P]   — unicoherence    max_{i<j}  sum_{n1} |sigma_{ij}(n1,n1)|

The paper's concentration theorem (Thm 10) applies when chi, mu = poly(n)
and mu~ = o(n / log^2 n); Sec 2.2 derives chi <= 3 / mu = O(1) / mu~ = 0 for
circulant and chi = 2 for Toeplitz.

We recover the P_i matrices **generically** for every structured kind by
exploiting linearity: a^i = g . P_i, so P_i = d(row i of A)/dg — one
jacobian of ``materialize`` w.r.t. the budget of randomness. This works
for any current or future P-model with zero per-class code.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import spinner


def p_matrices(kind: str, params: Dict[str, torch.Tensor], m: int, n: int
               ) -> np.ndarray:
    """(m, t, n) stack of the P_i matrices (rows a^i = g . P_i).

    Resolved through the spinner kind registry, so custom registered
    kinds get coherence diagnostics for free.
    """
    g = params["g"]
    gflat = g.reshape(-1)
    rest = {k: v.float() for k, v in params.items() if k != "g"}
    materialize = spinner.kind_def(kind).materialize

    def mat(gf):
        p = dict(rest, g=gf.reshape(g.shape))
        return materialize(p, m, n)

    jac = torch.func.jacfwd(mat)(gflat.float())      # (m, n, t)
    return jac.permute(0, 2, 1).cpu().numpy()


def sigma_tensor(pmats: np.ndarray) -> np.ndarray:
    """sigma_{i1,i2}(n1,n2) = <p^{i1}_{n1}, p^{i2}_{n2}>  -> (m, m, n, n)."""
    return np.einsum("ita,jtb->ijab", pmats, pmats)


def is_normalized(pmats: np.ndarray, atol: float = 1e-5) -> bool:
    """Def. 1: every column of every P_i has unit L2 norm."""
    norms = np.linalg.norm(pmats, axis=1)  # (m, n)
    return bool(np.all(np.abs(norms - 1.0) < atol))


def orthogonality_condition(pmats: np.ndarray, atol: float = 1e-5) -> bool:
    """Lemma 5's condition: any two columns of each P_i are orthogonal."""
    gram = np.einsum("ita,itb->iab", pmats, pmats)
    m, n, _ = gram.shape
    off = gram - np.eye(n)[None] * gram[:, np.arange(n), np.arange(n)][:, :, None]
    return bool(np.max(np.abs(off)) < atol)


# --- coherence graph -----------------------------------------------------------

def coherence_graph(sig_ij: np.ndarray, tol: float = 1e-8
                    ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """Vertices {n1<n2 : sigma != 0}; edges between intersecting pairs."""
    n = sig_ij.shape[0]
    verts = [(a, b) for a in range(n) for b in range(a + 1, n)
             if abs(sig_ij[a, b]) > tol]
    edges = []
    by_elem: Dict[int, List[int]] = {}
    for vi, (a, b) in enumerate(verts):
        by_elem.setdefault(a, []).append(vi)
        by_elem.setdefault(b, []).append(vi)
    for vs in by_elem.values():
        for x in range(len(vs)):
            for y in range(x + 1, len(vs)):
                edges.append((vs[x], vs[y]))
    return verts, sorted(set(edges))


def chromatic_number(n_verts: int, edges: List[Tuple[int, int]]) -> int:
    """Exact for max-degree <= 2 graphs (paths/cycles: 1, 2 or 3 via
    bipartiteness); greedy upper bound otherwise."""
    if n_verts == 0:
        return 0
    adj = [[] for _ in range(n_verts)]
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    if not edges:
        return 1
    maxdeg = max(len(a) for a in adj)
    if maxdeg <= 2:
        # union of paths/cycles: 2 if bipartite else 3
        color = [-1] * n_verts
        bipartite = True
        for s in range(n_verts):
            if color[s] >= 0:
                continue
            color[s] = 0
            stack = [s]
            while stack:
                u = stack.pop()
                for v in adj[u]:
                    if color[v] < 0:
                        color[v] = 1 - color[u]
                        stack.append(v)
                    elif color[v] == color[u]:
                        bipartite = False
        return 2 if bipartite else 3
    # greedy (Welsh-Powell order) upper bound
    order = sorted(range(n_verts), key=lambda v: -len(adj[v]))
    color = [-1] * n_verts
    for u in order:
        used = {color[v] for v in adj[u] if color[v] >= 0}
        c = 0
        while c in used:
            c += 1
        color[u] = c
    return max(color) + 1


def pmodel_stats(kind: str, params: Dict[str, torch.Tensor], m: int, n: int,
                 tol: float = 1e-6) -> Dict[str, float]:
    """chi[P], mu[P], mu~[P] plus normalization/orthogonality checks."""
    pm = p_matrices(kind, params, m, n)
    sig = sigma_tensor(pm)
    chi = 0
    for i in range(m):
        for j in range(m):
            verts, edges = coherence_graph(sig[i, j], tol)
            chi = max(chi, chromatic_number(len(verts), edges))
    iu = np.triu_indices(n, k=1)
    mu = 0.0
    for i in range(m):
        for j in range(m):
            mu = max(mu, float(np.sqrt(np.sum(sig[i, j][iu] ** 2) / n)))
    mu_t = 0.0
    for i in range(m):
        for j in range(i + 1, m):
            mu_t = max(mu_t, float(np.sum(np.abs(np.diagonal(sig[i, j])))))
    return {
        "chi": float(chi),
        "mu": mu,
        "mu_tilde": mu_t,
        "normalized": float(is_normalized(pm)),
        "orthogonal_cols": float(orthogonality_condition(pm)),
        "budget_t": float(pm.shape[1]),
    }


def block_stats(block: spinner.SpinnerBlock,
                params: Dict[str, torch.Tensor],
                tol: float = 1e-6) -> Dict[str, float]:
    """chi/mu/mu~ report for one SpinnerBlock (HD excluded: the quality
    parameters are properties of the structured A alone, Defs. 2-4)."""
    return pmodel_stats(block.kind, params, block.m, block.n, tol)


def pipeline_stats(pipe: spinner.SpinnerPipeline, params,
                   tol: float = 1e-6) -> List[Dict[str, float]]:
    """PER-BLOCK quality reports for a multi-block pipeline.

    The concentration machinery (Thm 10) applies blockwise — each block
    is an independent P-model; the report list is index-aligned with
    ``pipe.blocks``.
    """
    params = pipe.block_params(params)      # validates the per-block count
    return [block_stats(b, p, tol) for b, p in zip(pipe.blocks, params)]


ANALYTIC = {
    # paper Sec 2.2: circulant graphs are disjoint cycles -> chi <= 3, mu=O(1),
    # mu~ = 0; Toeplitz graphs are paths -> chi = 2 (Fig. 2), mu~ = 0.
    "circulant": {"chi_max": 3, "mu_tilde": 0.0},
    "skew_circulant": {"chi_max": 3, "mu_tilde": 0.0},
    "toeplitz": {"chi_max": 2, "mu_tilde": 0.0},
    "hankel": {"chi_max": 2, "mu_tilde": 0.0},
    "unstructured": {"chi_max": 1, "mu_tilde": 0.0},
}
