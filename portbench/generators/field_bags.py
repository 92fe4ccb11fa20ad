"""Multi-hot traffic with a fixed bag size a field (MLPerf's DLRM-DCNv2:
``--multi_hot_sizes``), read from a mix's parameters
(``portbench/traffic/<mix>.json`` names it as ``"generator":
"field_bags"``).

The ids are ``zipf_bags``'s: per field a Zipf pmf ``p_k ~ k^-exponent``
over the field's vocabulary, its ranks scattered over the ids by a
permutation a field drawn from the mix's ``catalog_seed``, the draws from
the seed, on the device. Each bag holds exactly its field's size
(``multi_hot_sizes`` of the configuration), so every seed asks for the
same work. A batch of ``n`` samples: ``sparse`` (n, sum of sizes) int32,
each sample's ids field by field; ``dense`` (n, n_dense) N(0, 1).
"""
from __future__ import annotations

import torch

from portbench.generate import generator
from portbench.generators import zipf_bags

_BATCH = zipf_bags._BATCH


class Traffic:
    def __init__(self, cfg: dict, mix: dict, device):
        if mix["bags"]["dist"] != "fixed":
            raise ValueError(f"unknown bags spec {mix['bags']}")
        self.cfg, self.mix, self.device = cfg, mix, device
        self.sizes = list(cfg["multi_hot_sizes"])
        # the one-hot form of the configuration: zipf_bags reads its ids
        # spec and nothing of the bags
        self.ids = zipf_bags.Traffic(dict(cfg, multi_hot=1), mix, device)

    def batch(self, seed: int, index: int, n: int) -> dict:
        g = generator(seed, _BATCH, self.device, index)
        dense = torch.randn((n, self.cfg["n_dense"]), generator=g,
                            device=self.device)
        sparse = torch.cat([self.ids.draw(f, (n, size), g)
                            for f, size in enumerate(self.sizes)], 1)
        return {"dense": dense, "sparse": sparse}
