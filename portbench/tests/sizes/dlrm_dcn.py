"""The small sizes of the ``dlrm_dcn`` family: every field and bag size
kept, each vocabulary capped at 600 rows, the widths cut."""


def small_cfg(cfg: dict) -> dict:
    cfg.update(vocab_sizes=[min(v, 600) for v in cfg["vocab_sizes"]],
               embed_dim=8, bot_mlp=[32, 8], top_mlp=[32, 16], cross_rank=4,
               chunk_rows=1000)
    return cfg
