"""The multi-GPU bank axis and fault tolerance (the port of the
reference's ``repro/dist``):

  * ``sharding``    — this rank's pieces of a recsys param, batch or
                      train-state tree (banked tables cut by rows over the
                      bank group, batches over dp), of an LM's params,
                      batch or KV cache, and of a GNN batch (edge lists
                      cut over the grid); ``DistCtx`` itself, the
                      data x model grid over ``torch.distributed``, lives
                      in ``core.embedding`` as in the reference
  * ``collectives`` — the spread placement of candidates and negatives
                      over the whole grid (``spread_slice``,
                      ``spread_gather``), the global top-k merge, the
                      cross-rank log-sum-exp, the sequence-sharded decode
                      attention, and ``pbroadcast`` / ``psum_replicated``
                      (replicated values in and out of rank-local work)
  * ``launch``      — ``run_ranks``: a function on every rank of a world
                      of spawned local processes (gloo on the CPU in the
                      tests, one rank per card or ranks sharing a card on
                      the GPU), arrays handed over as ``.npy`` files
  * ``fault``       — failure injection, straggler watchdog, restart loop
                      (exponential backoff + retryable-exception filter)
  * ``bank_fault``  — per-bank health model (healthy / degraded-slow /
                      dead) on a deterministic seeded injection schedule,
                      driving the serve loop's bounded-degraded reads
"""
