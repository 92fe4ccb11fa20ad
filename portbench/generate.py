"""The seeds' streams: each purpose draws from a ``torch.Generator`` of its
own, seeded from ``--seed`` and the purpose's tag. The weights come from
the configuration's reference (``portbench/reference/<reference>.py``,
tag ``WEIGHTS``), traffic from the generator that a mix names
(``portbench/generators/<generator>.py``, tags of its own).
"""
from __future__ import annotations

import torch

WEIGHTS = 1


def sub_seed(seed: int, tag: int, index: int = 0) -> int:
    return (int(seed) * 1_000_003 + tag * 7919 + index) % (1 << 62)


def generator(seed: int, tag: int, device, index: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag, index))
    return g
