"""Fault tolerance (the port of the reference's ``repro/dist``'s host-side
modules):

  * ``fault``       — failure injection, straggler watchdog, restart loop
                      (exponential backoff + retryable-exception filter)
  * ``bank_fault``  — per-bank health model (healthy / degraded-slow /
                      dead) on a deterministic seeded injection schedule,
                      driving the serve loop's bounded-degraded reads

The collectives and sharding policies of the multi-GPU bank axis are ROADMAP
queue 1 #16.
"""
