"""A general generator of DLRM traffic, read from a mix's parameters
(``portbench/traffic/<mix>.json`` names it as ``"generator": "zipf_bags"``).

Everything is drawn from ``--seed`` with ``torch.Generator``s on the
device, in a few large calls. Where the amount of work could depend on the
seed, it does not: the catalog (which ids are hot) is the mix's, and bag
lengths are a multiset drawn from the mix alone and ordered by the seed,
so every seed asks for the same work.

- ``ids``: per field a Zipf pmf ``p_k ~ k^-exponent`` over the field's
  vocabulary (``exponent`` 0 is uniform), its ranks scattered over the ids
  by a permutation a field drawn from the mix's ``catalog_seed``, the draws
  from the seed;
- ``bags`` (multi-hot configurations): lengths Poisson(``mean``) cut to
  ``[min, L]`` (L the config's ``multi_hot``), the tail of each bag padded
  with -1;
- ``dense``: N(0, 1); ``labels``: Bernoulli(``p``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.generate import generator

# the streams a seed feeds: each purpose draws from a generator of its own
_PERM, _BATCH, _LENGTHS = 2, 3, 4


class Traffic:
    """The mix's batches for a configuration: ``batch(seed, index, n)``,
    and ``popularity()``, the exact pmf of every row of the union
    vocabulary, which a deployment's profile of this traffic converges
    to."""

    def __init__(self, cfg: dict, mix: dict, device):
        spec = mix["ids"]
        if spec["dist"] != "zipf" or spec.get("permute") != "per_field":
            raise ValueError(f"unknown ids spec {spec}")
        if cfg["multi_hot"] > 1 and mix["bags"]["dist"] != "poisson":
            raise ValueError(f"unknown bags spec {mix['bags']}")
        self.cfg, self.mix, self.device = cfg, mix, device
        a = float(spec["exponent"])
        cdfs: dict[int, torch.Tensor] = {}
        self.cdf, self.perm = [], []
        g = generator(spec["catalog_seed"], _PERM, device)
        for v in cfg["vocab_sizes"]:
            if v not in cdfs:
                k = torch.arange(1, v + 1, dtype=torch.float64, device=device)
                c = torch.cumsum(k ** -a, 0)
                cdfs[v] = c / c[-1]
            self.cdf.append(cdfs[v])
            self.perm.append(torch.randperm(v, generator=g, device=device))

    def popularity(self) -> np.ndarray:
        """float64 on the host, fields in order."""
        out = []
        for cdf, perm in zip(self.cdf, self.perm):
            p = torch.diff(cdf, prepend=cdf.new_zeros(1))
            q = torch.empty_like(p)
            q[perm] = p
            out.append(q.cpu().numpy())
        return np.concatenate(out)

    def draw(self, f: int, shape, g: torch.Generator) -> torch.Tensor:
        """int32 ids of field ``f``, ``shape`` of them."""
        n = math.prod(shape)
        u = torch.rand(n, dtype=torch.float64, generator=g,
                       device=self.device)
        k = torch.searchsorted(self.cdf[f], u, right=True)
        k.clamp_(max=self.cdf[f].shape[0] - 1)
        return self.perm[f][k].to(torch.int32).reshape(shape)

    def _lengths(self, n: int, index: int, seed: int) -> torch.Tensor:
        """n bag lengths: a multiset fixed by the mix and ``index``, in an
        order drawn from the seed."""
        spec, L, dev = self.mix["bags"], self.cfg["multi_hot"], self.device
        fixed = generator(0, _LENGTHS, dev, index)
        lam = torch.full((n,), float(spec["mean"]), device=dev)
        lens = torch.poisson(lam, generator=fixed).clamp_(spec.get("min", 1),
                                                           L)
        order = torch.randperm(n, generator=generator(seed, _LENGTHS, dev,
                                                      index), device=dev)
        return lens[order].to(torch.int32)

    def batch(self, seed: int, index: int, n: int) -> dict:
        """Batch ``index``: ``n`` samples of dense (n, n_dense) fp32, sparse
        (n, F) one-hot or (n, F, L) -1-padded bags (int32), and ``label``
        (n,) fp32 where the mix has labels."""
        cfg, dev = self.cfg, self.device
        g = generator(seed, _BATCH, dev, index)
        F, L = len(cfg["vocab_sizes"]), cfg["multi_hot"]
        dense = torch.randn((n, cfg["n_dense"]), generator=g, device=dev)
        if L == 1:
            sparse = torch.stack([self.draw(f, (n,), g) for f in range(F)], 1)
        else:
            lens = self._lengths(n * F, index, seed).reshape(n, F)
            sparse = torch.empty((n, F, L), dtype=torch.int32, device=dev)
            pos = torch.arange(L, device=dev, dtype=torch.int32)[None, :]
            for f in range(F):
                x = self.draw(f, (n, L), g)
                x.masked_fill_(pos >= lens[:, f:f + 1], -1)
                sparse[:, f] = x
        out = {"dense": dense, "sparse": sparse}
        if "labels" in self.mix:
            p = torch.full((n,), float(self.mix["labels"]["p"]), device=dev)
            out["label"] = torch.bernoulli(p, generator=g)
        return out
