"""Scenario panels drawn from an INDEP DISCRETE .sto, from the seed.

Each random right-hand side takes one of its outcomes with its
probability; a panel holds deltas (outcome minus the .cor's value), one
row a scenario, one column a random variable in the .sto's order. Draws
come from a ``torch.Generator`` on the device the panel is made on, in a
few calls a panel, so the same seed gives the same panels there.

- ``iid``: independent draws, u ~ U[0, 1) per entry.
- ``lhs``: Latin hypercube over S scenarios: each variable's S draws take
  one of the S strata [k/S, (k+1)/S) each, in a random order, at a
  uniform point inside it.

A uniform u picks the first outcome whose cumulative probability exceeds
it.
"""

from __future__ import annotations

import torch

from sdbench.smps import Discrete


class Sampler:
    def __init__(self, disc: Discrete, device):
        V = max(len(v) for v in disc.values)
        n = len(disc.values)
        values = torch.zeros(n, V, dtype=torch.float64)
        cdf = torch.ones(n, V, dtype=torch.float64)
        for k, (v, p) in enumerate(zip(disc.values, disc.probs)):
            values[k, :len(v)] = torch.as_tensor(v)
            values[k, len(v):] = float(v[-1])
            c = torch.cumsum(torch.as_tensor(p), 0)
            cdf[k, :len(v)] = c
            cdf[k, len(v) - 1:] = 1.0
        self.device = torch.device(device)
        self.values = values.to(self.device)
        self.cdf = cdf.to(self.device)
        self.base = torch.as_tensor(disc.base, dtype=torch.float64,
                                    device=self.device)
        self.n_rv = n

    def _pick(self, u: torch.Tensor) -> torch.Tensor:
        """[..., Rv] uniforms -> [..., Rv] float64 deltas."""
        idx = (u[..., None] >= self.cdf).sum(-1).clamp_(max=self.cdf.shape[1]
                                                         - 1)
        vals = torch.gather(self.values.expand(u.shape + (-1,)), -1,
                            idx[..., None])[..., 0]
        return vals - self.base

    def iid(self, gen: torch.Generator, B: int) -> torch.Tensor:
        u = torch.rand((B, self.n_rv), generator=gen, dtype=torch.float64,
                       device=self.device)
        return self._pick(u)

    def lhs(self, gen: torch.Generator, S: int) -> torch.Tensor:
        keys = torch.rand((self.n_rv, S), generator=gen, dtype=torch.float64,
                          device=self.device)
        strata = torch.argsort(keys, dim=1).to(torch.float64)
        jitter = torch.rand((self.n_rv, S), generator=gen,
                            dtype=torch.float64, device=self.device)
        return self._pick(((strata + jitter) / S).T.contiguous())
