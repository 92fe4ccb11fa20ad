"""Partitioning, GRACE mining, the cache runtime and the paper's hardware
cost model ``hwmodel`` (numpy); the banked embedding lookup (torch)."""
from repro_torch.core.partitioning import expert_placement
from repro_torch.core.embedding import (BankedTable, banked_cache_residual_bag,
                                        banked_embedding_bag, banked_gather,
                                        csr_embedding_bag, lookup_unsharded,
                                        pack_table, init_banked)
