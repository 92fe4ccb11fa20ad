"""Each hand-written kernel's cost for one call: the bytes it must move and
the fp32 operations it must do, as PERF.md §6's bound column counts them
(each id and offset read once, each distinct remap entry once, each
distinct table row once, the output written once; an add per live entry
and column). Every function returns ``(bytes, operations)``.

The counts that depend on the ids (live entries, distinct entries and
rows, runs) are arguments. On ``meta`` tensors the ids are unknown, and
the wrappers count with the ``meta_*`` forms: every entry live, and as
many distinct entries and rows as the entries could touch, at most the
table's (``min(entries, rows)``); those are the reports that
``launch/roofline.CostCounter`` receives in place of a launch.
"""
from __future__ import annotations


def bag_cost(nb: int, bag_len: int, dim: int, itemsize: int, *,
             n_valid: int, n_entries: int, n_rows: int, n_fields: int = 1,
             owned_test: bool = False, remap: bool = True
             ) -> tuple[int, int]:
    """``banked_bag`` (rows 1, 1r) and, ``remap=False``, ``plain_bag``
    (row 7): the (NB, L) int32 ids, the field offsets, each of
    ``n_entries`` distinct remap entries (its slot, and its bank when the
    call tests ownership), ``n_rows`` distinct rows of ``dim`` values, the
    (NB, D) output; an add per live entry and column."""
    nbytes = (nb * bag_len * 4 + n_rows * dim * itemsize + nb * dim * itemsize
              + remap * (n_fields * 4 + n_entries * (4 + 4 * owned_test)))
    return nbytes, n_valid * dim


def cache_bag_cost(nb: int, cache_len: int, residual_len: int, dim: int,
                   itemsize: int, *, n_valid: int, n_rows: int,
                   remap: bool = True) -> tuple[int, int]:
    """``cache_residual_bag`` (row 4) and, ``remap=False``,
    ``plain_cache_bag`` (row 8), summed over both streams: the ids, each of
    ``n_rows`` distinct rows of either table (its 4-byte slot, unless the
    layout is the identity, and its values), the output; an add per live
    entry and column."""
    nbytes = (nb * (cache_len + residual_len) * 4
              + n_rows * (4 * remap + dim * itemsize) + nb * dim * itemsize)
    return nbytes, n_valid * dim


def csr_bag_cost(n_ids: int, n_bags: int, dim: int, itemsize: int, *,
                 n_valid: int, n_entries: int, n_rows: int,
                 owned_test: bool = False,
                 out_itemsize: int | None = None) -> tuple[int, int]:
    """``csr_bag`` (row 5): the stream, its ``n_bags + 1`` offsets, each
    distinct remap entry (slot, and bank when testing ownership), each
    distinct row, the output (``out_itemsize`` bytes a value, None: the
    table's); an add per live entry and column."""
    out = itemsize if out_itemsize is None else out_itemsize
    nbytes = (n_ids * 4 + (n_bags + 1) * 4 + n_entries * (4 + 4 * owned_test)
              + n_rows * dim * itemsize + n_bags * dim * out)
    return nbytes, n_valid * dim


def tiered_bag_cost(nb: int, bag_len: int, dim: int, *, n_fields: int,
                    n_valid: int, n_rows: int, n_scaled_rows: int,
                    row_bytes: int, n_scaled_entries: int
                    ) -> tuple[int, int]:
    """``tiered_bag`` (row 6): the ids and offsets, each of ``n_rows``
    distinct rows' slot and tier (8 bytes), the scale of each of
    ``n_scaled_rows`` non-hot rows, ``row_bytes`` of payload in all (each
    distinct row at its tier's width), the fp32 output; an add per live
    entry and column and a dequant multiply per scaled entry and column."""
    nbytes = (nb * bag_len * 4 + n_fields * 4 + n_rows * 8 + n_scaled_rows * 4
              + row_bytes + nb * dim * 4)
    return nbytes, (n_valid + n_scaled_entries) * dim


def scatter_cost(nb: int, dim: int, ct_itemsize: int, out_itemsize: int, *,
                 n_live: int, n_run: int) -> tuple[int, int]:
    """``ct_scatter`` (row 3) on its prep's runs: each live entry's
    cotangent row id, each live run's start (and the end) and slot, the run
    count, the (NB, D) cotangent, each run's destination row written once;
    an add per live entry and column."""
    nbytes = (n_live * 4 + (n_run + 1) * 4 + n_run * 4 + 4
              + nb * dim * ct_itemsize + n_run * dim * out_itemsize)
    return nbytes, n_live * dim


def dot_cost(batch: int, n_fields: int, dim: int,
             itemsize: int) -> tuple[int, int]:
    """``dot_interaction`` (row 2): z (B, F, D) read, the (B, P) dots
    written; a multiply and an add per pair and column."""
    p = n_fields * (n_fields - 1) // 2
    return (batch * n_fields * dim + batch * p) * itemsize, 2 * batch * p * dim


def dot_features_cost(batch: int, n_fields: int, dim: int,
                      itemsize: int) -> tuple[int, int]:
    """``dot_features`` (row 2f): x and emb ((B, F, D) in all) read, the
    (B, P + D) features written; the dots' operations."""
    p = n_fields * (n_fields - 1) // 2
    return ((batch * n_fields * dim + batch * (p + dim)) * itemsize,
            2 * batch * p * dim)


def dot_features_query_cost(n_cand: int, n_user: int, dim: int,
                            itemsize: int) -> tuple[int, int]:
    """``dot_features_query`` (row 2q): x, the ``n_user`` user rows and the
    (N, D) candidate rows read, the (N, P + D) features written (F = U +
    2); the (U+1)U/2 dots among x and the user rows once and the U + 1
    against each candidate, a multiply and an add per column."""
    p = (n_user + 2) * (n_user + 1) // 2
    q_pairs = (n_user + 1) * n_user // 2
    nbytes = ((1 + n_user) * dim + n_cand * dim + n_cand * (p + dim)) * itemsize
    return nbytes, 2 * (q_pairs + n_cand * (n_user + 1)) * dim


# ---------------------------------------------------------------------------
# the data-free counts of a call on meta tensors
# ---------------------------------------------------------------------------

def meta_bag_cost(nb: int, bag_len: int, dim: int, itemsize: int, *,
                  n_remap: int, n_table_rows: int, n_fields: int = 1,
                  owned_test: bool = False, remap: bool = True
                  ) -> tuple[int, int]:
    """``bag_cost`` with every entry live and distinct up to the remap's
    ``n_remap`` entries and the table's ``n_table_rows`` rows."""
    e = nb * bag_len
    n_entries = min(e, n_remap)
    return bag_cost(nb, bag_len, dim, itemsize, n_valid=e,
                    n_entries=n_entries, n_rows=min(n_entries, n_table_rows),
                    n_fields=n_fields, owned_test=owned_test, remap=remap)


def meta_cache_bag_cost(nb: int, cache_len: int, residual_len: int, dim: int,
                        itemsize: int, *, cache_rows: int, emt_rows: int,
                        remap: bool = True) -> tuple[int, int]:
    return cache_bag_cost(
        nb, cache_len, residual_len, dim, itemsize,
        n_valid=nb * (cache_len + residual_len),
        n_rows=min(nb * cache_len, cache_rows)
        + min(nb * residual_len, emt_rows), remap=remap)


def meta_csr_bag_cost(n_ids: int, n_bags: int, dim: int, itemsize: int, *,
                      n_remap: int, n_table_rows: int,
                      owned_test: bool = False,
                      out_itemsize: int | None = None) -> tuple[int, int]:
    n_entries = min(n_ids, n_remap)
    return csr_bag_cost(n_ids, n_bags, dim, itemsize, n_valid=n_ids,
                        n_entries=n_entries,
                        n_rows=min(n_entries, n_table_rows),
                        owned_test=owned_test, out_itemsize=out_itemsize)


def meta_tiered_bag_cost(nb: int, bag_len: int, dim: int, *, n_fields: int,
                         n_remap: int, n_table_rows: int,
                         payload_row_bytes: int) -> tuple[int, int]:
    """Every distinct row at the payload's full row width and scaled."""
    e = nb * bag_len
    n_rows = min(e, n_remap, n_table_rows)
    return tiered_bag_cost(nb, bag_len, dim, n_fields=n_fields, n_valid=e,
                           n_rows=n_rows, n_scaled_rows=n_rows,
                           row_bytes=n_rows * payload_row_bytes,
                           n_scaled_entries=e)


def meta_scatter_cost(nb: int, dim: int, ct_itemsize: int,
                      out_itemsize: int, *, n_entries: int,
                      n_out_rows: int) -> tuple[int, int]:
    return scatter_cost(nb, dim, ct_itemsize, out_itemsize, n_live=n_entries,
                        n_run=min(n_entries, n_out_rows))
