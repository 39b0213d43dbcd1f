"""Optimal-transport noise pairing for flow-matching training.

Counterpart of ``moviigen_tpu/training/ot.py`` (ref
``scripts/train/util/math_util.py::cosine_optimal_transport`` as used by
``finetune.py::process_batch``, ``--compute_ot``): each latent of the
batch is paired with the noise row that minimises the total cosine
distance, a batch linear assignment, and ``noise = noise[col_ind]``.

The assignment is exact. For B ≤ ``BRUTE_FORCE_MAX`` (8) it stays on the
device: every one of the B! permutations is scored by gathers and adds in
row order, and the first minimum wins, as ``argmin`` picks it. Above that the
Hungarian method runs on the host
(``scipy.optimize.linear_sum_assignment``), as in the JAX package.
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

BRUTE_FORCE_MAX = 8


def cosine_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negative cosine similarity ``C[i, j] = -x̂_i · ŷ_j`` over the
    flattened rows (math_util.py:20-24), in fp32 at full precision: the
    assignment is decided on differences a reduced-precision product
    could flip, so TF32 must be off (``torch.backends.cuda.matmul.
    allow_tf32``, off by default)."""
    x = x.reshape(x.shape[0], -1).float()
    y = y.reshape(y.shape[0], -1).float()
    xn = x / torch.linalg.norm(x, dim=1, keepdim=True)
    yn = y / torch.linalg.norm(y, dim=1, keepdim=True)
    return -torch.matmul(xn, yn.t())


@lru_cache(maxsize=None)
def _perm_table(n: int) -> np.ndarray:
    return np.array(list(itertools.permutations(range(n))), dtype=np.int64)


def linear_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Exact minimum-cost assignment: ``col_ind`` (int64, on the cost's
    device) with row i matched to column ``col_ind[i]``."""
    n = cost.shape[0]
    if n <= BRUTE_FORCE_MAX:
        perms = torch.from_numpy(_perm_table(n)).to(cost.device)  # (n!, n)
        # Σ_i cost[i, perm[i]], added row by row in order: a reduction
        # kernel may group the terms differently per permutation, and two
        # permutations that tie exactly would then not tie
        totals = cost[0, perms[:, 0]]
        for i in range(1, n):
            totals = totals + cost[i, perms[:, i]]
        return perms[torch.argmin(totals)]
    from scipy.optimize import linear_sum_assignment

    col = linear_sum_assignment(cost.detach().cpu().numpy())[1]
    return torch.from_numpy(col.astype(np.int64)).to(cost.device)


def cosine_optimal_transport(x: torch.Tensor, y: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cost_matrix, col_ind)``: row i of ``x`` pairs with row
    ``col_ind[i]`` of ``y`` (math_util.py:8-29)."""
    cost = cosine_cost(x, y)
    return cost, linear_assignment(cost)


def ot_pair_noise(latents: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``noise`` permuted so that each latent gets its OT-matched noise
    row (finetune.py:206-208); unchanged for a batch of one. A
    permutation keeps the noise an i.i.d. Gaussian batch: only the
    pairing changes."""
    if latents.shape[0] <= 1:
        return noise
    _, col = cosine_optimal_transport(latents, noise)
    return noise[col]
