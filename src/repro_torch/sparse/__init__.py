"""Embedding bags, segment reductions and the GNN neighbor sampler
(``sampler``) over ragged (CSR) data."""
from repro_torch.sparse.ops import (segment_max, segment_mean,
                                    segment_softmax, segment_sum)

__all__ = ["segment_max", "segment_mean", "segment_softmax", "segment_sum"]
