"""Dual-vertex pool with approximate dedup, on tensors.

Port of record: ``sqlp_tpu/sd/dual_pool.py`` (``round_sig_bits`` :22-35,
``push_duals`` :38-103). A batch of candidates is folded in order (the
``lax.scan`` becomes a Python loop over the few 2EB candidates of a step),
so within-batch duplicates dedup exactly like sequential pushes; at
capacity the lowest usage-score vertex is evicted. Every update stays on
the device: no host read.
"""

from __future__ import annotations

import torch


def round_sig_bits(x: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """Round to ``bits`` significant binary digits (Julia's
    ``round(x; base=2, sigdigits=bits)``): x = m 2^e with |m| in [0.5, 1),
    keep ``bits`` mantissa bits. ``ldexp`` gives an exact power of two;
    ``torch.round`` rounds half to even like ``jnp.round``. Subnormal
    inputs round to 0, as the JAX function's do under XLA's flush of
    denormals on the CPU; the smallest normals overflow ``scale`` to inf
    and give NaN in both."""
    x = torch.where(torch.abs(x) < torch.finfo(x.dtype).tiny,
                    torch.zeros_like(x), x)
    _, e = torch.frexp(x)
    scale = torch.ldexp(torch.ones_like(x), bits - e)
    rounded = torch.round(x * scale) / scale
    return torch.where(x == 0, torch.zeros_like(x), rounded)


def push_duals(duals: torch.Tensor, rounded: torch.Tensor, n: torch.Tensor,
               new_pis: torch.Tensor, dropped: torch.Tensor,
               sig_bits: int = 16, valid=None, score=None):
    """Push a batch of dual vectors into the pool with dedup.

    duals, rounded [D, m2]; n, dropped int32 scalars; new_pis [P, m2]
    pushed in order; valid optional [P] bool (False entries skipped);
    score optional [D] usage score (eviction by lowest score, fresh
    entries start at the live mean). Returns (duals, rounded, n, dropped)
    plus the updated score when ``score`` was given.
    """
    D = duals.shape[0]
    dev = duals.device
    if valid is None:
        valid = torch.ones(new_pis.shape[0], dtype=torch.bool, device=dev)
    with_score = score is not None
    if not with_score:
        score = torch.zeros(D, dtype=duals.dtype, device=dev)
    slots = torch.arange(D, device=dev)
    inf = torch.full((), float("inf"), dtype=score.dtype, device=dev)
    zero = torch.zeros((), dtype=score.dtype, device=dev)
    prs = round_sig_bits(new_pis, sig_bits)
    for p in range(new_pis.shape[0]):
        pi, pr, ok = new_pis[p], prs[p], valid[p]
        live = slots < n
        dup = ~ok | torch.any(live & torch.all(rounded == pr[None, :], dim=1))
        append = ~dup & (n < D)
        evict = ~dup & (n >= D)
        if with_score:
            evict_idx = torch.argmin(torch.where(live, score, inf))
        else:
            evict_idx = (dropped % D).long()
        idx = torch.where(append, torch.clamp_max(n, D - 1).long(),
                          evict_idx)
        write = append | evict
        duals = duals.index_put((idx,), torch.where(write, pi, duals[idx]))
        rounded = rounded.index_put((idx,),
                                    torch.where(write, pr, rounded[idx]))
        if with_score:
            grace = torch.sum(torch.where(live, score, zero)) \
                / torch.clamp_min(n, 1).to(score.dtype)
            score = score.index_put((idx,),
                                    torch.where(write, grace, score[idx]))
        n = n + append.to(n.dtype)
        dropped = dropped + evict.to(dropped.dtype)
    if with_score:
        return duals, rounded, n, dropped, score
    return duals, rounded, n, dropped
