"""Useful ("textbook") FLOPs of one step of a cell (the port of
``repro/launch/roofline.py``'s ``model_flops``, ``_recsys_dense_params``
and ``_gat_flops``): plain arithmetic over ``configs/shapes``' cells and
the registry's full configs, the numerator of a step's useful FLOP rate.
The reference's compile-side terms (``analyze_hlo``, ``roofline_terms``)
are not here: they read XLA's compiled modules.
"""
from __future__ import annotations


def model_flops(arch_id: str, shape_id: str) -> float:
    """Global textbook FLOPs for one step of the cell."""
    from repro_torch.configs import get_arch
    from repro_torch.configs import shapes as SH
    spec = get_arch(arch_id)
    cell = SH.get_cell(arch_id, shape_id)
    d = cell.dims
    fam = spec.family
    cfg = spec.config

    if fam == "lm":
        B, S = d["batch"], d["seq"]
        N = cfg.active_param_count()
        if cell.step_kind == "train":
            # 6·N·D + attention quadratic term (12·L·d_attn·S² per seq ×3)
            attn = 3 * cfg.n_layers * 4 * B * S * S * cfg.qkv_dim
            return 6.0 * N * (B * S) + attn
        if cell.step_kind == "prefill":
            attn = cfg.n_layers * 4 * B * S * S * cfg.qkv_dim * 0.5
            return 2.0 * N * (B * S) + attn
        # decode: one token per sequence + KV attention
        attn = cfg.n_layers * 4 * B * S * cfg.qkv_dim
        return 2.0 * N * B + attn

    if fam in ("dlrm", "din", "bert4rec", "xdeepfm"):
        B = d.get("n_candidates", d["batch"]) \
            if cell.step_kind == "retrieval" else d["batch"]
        dense = _recsys_dense_params(spec)
        mult = 6.0 if cell.step_kind == "train" else 2.0
        return mult * dense * B

    if fam == "gat":
        return _gat_flops(spec, cell)
    raise ValueError(fam)


def _recsys_dense_params(spec) -> float:
    cfg = spec.config
    total = cfg.param_count()
    if spec.family in ("dlrm", "xdeepfm", "din"):
        emb = cfg.total_vocab * cfg.embed_dim
        if spec.family == "xdeepfm":
            emb = cfg.total_vocab * (cfg.embed_dim + 1)
        return max(total - emb, 1)
    # bert4rec: per-sequence transformer cost + the MLM head. The head's
    # useful work depends on the loss: full-catalog softmax scores S x V,
    # sampled softmax scores max_masked x (1 + n_negatives).
    emb = cfg.vocab * cfg.embed_dim
    per_tok = max(cfg.param_count() - emb - cfg.seq_len * cfg.embed_dim, 1)
    body = per_tok * cfg.seq_len
    if getattr(cfg, "loss", "full") == "sampled":
        head = cfg.max_masked * (1 + cfg.n_negatives) * cfg.embed_dim
    else:
        head = cfg.seq_len * cfg.vocab * cfg.embed_dim
    return body + head


def _gat_flops(spec, cell) -> float:
    """Two layers' projections (2·n·in·out) and edge work (8 a head-out
    element an edge: scores, softmax, message, sum), x3 for the
    backward; the sampled cell at its padded block sizes."""
    d = cell.dims
    cfg = spec.config
    H, O = cfg.n_heads, cfg.d_hidden
    if cell.shape_id == "minibatch_lg":
        from repro_torch.configs.shapes import sampled_block_dims
        bd = sampled_block_dims(d["batch_nodes"], d["fanout0"], d["fanout1"])
        n, e = bd["n0"], bd["e0"] + bd["e1"]
        feat = d["d_feat"]
    elif cell.shape_id == "molecule":
        n = d["n_graphs"] * d["nodes_per"]
        e = d["n_graphs"] * d["edges_per"]
        feat = d["d_feat"]
    else:
        n, e, feat = d["n_nodes"], d["n_edges"], d["d_feat"]
    l1 = 2 * n * feat * H * O + 8 * e * H * O
    l2 = 2 * n * H * O * d["n_classes"] + 8 * e * d["n_classes"]
    return 3.0 * (l1 + l2)   # fwd+bwd
