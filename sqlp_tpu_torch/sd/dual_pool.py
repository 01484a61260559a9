"""Dual-vertex pool with approximate dedup, on tensors.

Port of record: ``sqlp_tpu/sd/dual_pool.py`` (``round_sig_bits`` :22-35,
``push_duals`` :38-103). A batch of candidates is folded in order (the
``lax.scan`` becomes a Python loop over the few 2EB candidates of a step),
so within-batch duplicates dedup exactly like sequential pushes; at
capacity the lowest usage-score vertex is evicted. Every update stays on
the device: no host read.

``push_duals(..., axis=)`` pushes into a pool sharded in row blocks along
a mesh axis (``parallel/mesh.py``): each candidate's facts (does a live
row here equal it, this block's lowest live score and its index, the
sum of its live scores) travel in one all-gather, and every rank takes
the same decision from them; the rank that owns the slot writes it.
"""

from __future__ import annotations

import torch

from sqlp_tpu_torch.parallel.mesh import global_argmin_lowest, offset_of


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
               sig_bits: int = 16, valid=None, score=None, axis=None):
    """Push a batch of dual vectors into the pool with dedup.

    duals, rounded [D, m2]; n, dropped int32 scalars; new_pis [P, m2]
    pushed in order; valid optional [P] bool (False entries skipped);
    score optional [D] usage score (eviction by lowest score, fresh
    entries start at the live mean). Returns (duals, rounded, n, dropped)
    plus the updated score when ``score`` was given. With ``axis`` the
    pool arrays are this rank's block of a pool sharded along it, and the
    slots, ``n`` and ``dropped`` count the global pool.
    """
    if axis is not None and axis.size > 1:
        return _push_sharded(duals, rounded, n, new_pis, dropped, sig_bits,
                             valid, score, axis)
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


def _push_sharded(duals, rounded, n, new_pis, dropped, sig_bits, valid,
                  score, axis):
    """``push_duals`` on one rank's row block (module docstring)."""
    D_loc = duals.shape[0]
    D = D_loc * axis.size
    dev = duals.device
    if valid is None:
        valid = torch.ones(new_pis.shape[0], dtype=torch.bool, device=dev)
    with_score = score is not None
    if not with_score:
        score = torch.zeros(D_loc, dtype=duals.dtype, device=dev)
    off = offset_of(axis, D_loc)
    slots = off + torch.arange(D_loc, device=dev)
    inf = torch.full((), float("inf"), dtype=score.dtype, device=dev)
    zero = torch.zeros((), dtype=score.dtype, device=dev)
    f8 = torch.float64
    prs = round_sig_bits(new_pis, sig_bits)
    for p in range(new_pis.shape[0]):
        pi, pr, ok = new_pis[p], prs[p], valid[p]
        live = slots < n
        here = torch.any(live & torch.all(rounded == pr[None, :], dim=1))
        carry = torch.stack([here.to(f8), torch.sum(
            torch.where(live, score, zero)).to(f8)])
        lowest, got = global_argmin_lowest(torch.where(live, score, inf),
                                           axis, off, carry=carry)
        dup = ~ok | torch.any(got[:, 0] > 0)
        append = ~dup & (n < D)
        evict = ~dup & (n >= D)
        evict_idx = lowest if with_score else (dropped % D).long()
        idx = torch.where(append, torch.clamp_max(n, D - 1).long(),
                          evict_idx)
        write = (append | evict) & (idx >= off) & (idx < off + D_loc)
        at = torch.clamp(idx - off, 0, D_loc - 1)
        duals = duals.index_put((at,), torch.where(write, pi, duals[at]))
        rounded = rounded.index_put((at,),
                                    torch.where(write, pr, rounded[at]))
        if with_score:
            # the blocks' live sums, added in rank order in the score's
            # dtype (each was summed in it)
            parts = got[:, 1].to(score.dtype)
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            grace = total / torch.clamp_min(n, 1).to(score.dtype)
            score = score.index_put((at,),
                                    torch.where(write, grace, score[at]))
        n = n + append.to(n.dtype)
        dropped = dropped + evict.to(dropped.dtype)
    if with_score:
        return duals, rounded, n, dropped, score
    return duals, rounded, n, dropped
