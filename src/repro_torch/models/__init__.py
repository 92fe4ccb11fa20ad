"""The model families: DLRM, DIN, BERT4Rec, xDeepFM, the LM transformers
(``lm``: ``models/transformer.py``) and GAT (``gat``)."""
from __future__ import annotations

import importlib


def family_module(family: str):
    """The model module of a registry family (``ArchSpec.family``)."""
    if family == "lm":
        return importlib.import_module("repro_torch.models.transformer")
    if family not in ("dlrm", "din", "bert4rec", "xdeepfm", "gat"):
        raise ValueError(f"family {family!r} is not ported")
    return importlib.import_module(f"repro_torch.models.{family}")
