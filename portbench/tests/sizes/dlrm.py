"""The small sizes of the ``dlrm`` family: the port's reduced registry
entries (``test_portbench_counts`` holds them to the registry)."""


def small_cfg(cfg: dict) -> dict:
    if cfg["multi_hot"] > 1:
        cfg.update(vocab_sizes=[500] * 8, embed_dim=8, bot_mlp=[32, 8],
                   top_mlp=[32], multi_hot=16)
    else:
        cfg.update(vocab_sizes=[100, 80, 60], embed_dim=8, bot_mlp=[32, 8],
                   top_mlp=[32, 16])
    return cfg
