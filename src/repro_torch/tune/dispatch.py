"""Shape-specialized dispatch cache: the persisted half of the autotuner
(the port of ``repro/tune/dispatch.py``; stdlib only).

Every lookup entry point in ``core/embedding.py`` can run with
``backend='tuned'``: it builds a ``CallSignature`` from the call's shapes
and resolves it through the module-level ``DispatchCache``, a host-side
dict lookup per call with no file IO after the first load.

On the card the reference's three knobs mean:

  * backend — ``'cuda'``, the hand-written kernel; ``'torch'``, its plain
    version, is the CPU's only implementation and never a decision for CUDA
    tensors;
  * ``tile_b`` — bags per block of the bag kernels (1 or 2, a warp a bag);
  * ``n_slots`` — stages of 32 rows in the kernels' ``cp.async`` ring (1 to
    8).

``None`` for either means the fixed rule of
``kernels/embedding_bag.bag_geometry`` / ``ring_geometry``.

The cache is ``TUNE_dispatch_cuda.json`` at the repo root, written by
``launch/tune.py``. Its entry keys are the signature strings, byte for byte
the reference's; an entry holds the decision (``backend``, ``tile_b``,
``n_slots``) and its measurements (``*_us``).

A MISS falls back to the caller's ``tile_b``/``n_slots`` and the ``auto``
rule (``'cuda'`` for CUDA tensors, ``'torch'`` for CPU ones), so
``backend='tuned'`` with no cache file behaves exactly like ``'auto'``.

Resolution order for the cache file: ``$REPRO_TORCH_TUNE_CACHE`` > cwd >
repo root. ``set_cache()`` overrides in-process (tests, the autotuner's
self-check). The reference's ``TUNE_dispatch.json`` and
``$REPRO_TUNE_CACHE`` are never read: their decisions were measured on
another machine.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading

CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"
CACHE_BASENAME = "TUNE_dispatch_cuda.json"
SCHEMA_VERSION = 1

#: lookup paths a signature can name — one per core/embedding entry point
PATHS = ("plain", "fused", "csr", "tiered", "replicated")

#: backends a cached decision may select (never "auto"/"tuned" — a decision
#: is the OUTPUT of resolution)
DECISION_BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class CallSignature:
    """The static shape tuple a dispatch decision is keyed on.

    ``bag_len`` is a string so non-rectangular paths can encode their shape
    ("4+8" for the fused cache+residual pair, "ragged" for CSR). ``batch``
    is the PRODUCT of the index leading dims (B, or B*F for multi-field
    batches). ``tier_mix`` is the tiered path's hot dtype ("none"
    elsewhere)."""

    path: str
    vocab: int
    dim: int
    batch: int
    bag_len: str
    n_fields: int = 1
    k_max: int = 1
    tier_mix: str = "none"
    bwd_backend: str = "auto"

    def __post_init__(self):
        if self.path not in PATHS:
            raise ValueError(f"path must be one of {PATHS}, got {self.path!r}")

    def key(self) -> str:
        """Deterministic string key (the JSON entry key)."""
        return _key(self.path, self.vocab, self.dim, self.batch,
                    self.bag_len, self.n_fields, self.k_max, self.tier_mix,
                    self.bwd_backend)


def _key(path: str, vocab: int, dim: int, batch: int, bag_len: str,
         n_fields: int, k_max: int, tier_mix: str, bwd_backend: str) -> str:
    return (f"{path}|v{vocab}|d{dim}|b{batch}|l{bag_len}|f{n_fields}"
            f"|k{k_max}|t{tier_mix}|bw{bwd_backend}")


def signature(path: str, *, vocab: int, dim: int, batch: int, bag_len,
              n_fields: int = 1, k_max: int = 1, tier_mix: str = "none",
              bwd_backend: str = "auto") -> CallSignature:
    """Normalizing constructor: ``bag_len`` may be an int or a string."""
    return CallSignature(path=path, vocab=int(vocab), dim=int(dim),
                         batch=int(batch), bag_len=str(bag_len),
                         n_fields=int(n_fields), k_max=int(k_max),
                         tier_mix=str(tier_mix), bwd_backend=str(bwd_backend))


@dataclasses.dataclass(frozen=True)
class Decision:
    """What a resolved lookup runs with. ``source`` records whether the
    cache hit ("cache") or the deterministic default applied ("default").
    ``tile_b``/``n_slots`` None: the fixed geometry rule."""

    backend: str
    tile_b: int | None
    n_slots: int | None
    source: str = "default"

    def __post_init__(self):
        if self.backend not in DECISION_BACKENDS:
            raise ValueError(f"decision backend must be one of "
                             f"{DECISION_BACKENDS}, got {self.backend!r}")


def _choice(e: dict) -> tuple[str, int, int]:
    return e["backend"], int(e["tile_b"]), int(e["n_slots"])


class DispatchCache:
    """signature key -> decision entry, with JSON persistence.

    An entry dict holds the decision (``backend``, ``tile_b``, ``n_slots``)
    plus measurement provenance (``best_us``, ``cuda_us``, ``torch_us``,
    ...). ``hits``/``misses`` count ``lookup`` outcomes — the tests use them
    to prove a tuned call consulted the cache rather than falling back.
    """

    def __init__(self, entries: dict | None = None,
                 meta: dict | None = None):
        self.entries: dict[str, dict] = dict(entries or {})
        self.meta: dict = dict(meta or {})
        self.meta.setdefault("version", SCHEMA_VERSION)
        self.hits = 0
        self.misses = 0
        # key -> (backend, tile_b, n_slots), filled as keys are looked up
        self._choices: dict[str, tuple[str, int, int]] = {}

    def lookup(self, sig: CallSignature) -> Decision | None:
        c = self.choice(sig.key())
        return None if c is None else Decision(*c, source="cache")

    def choice(self, key: str) -> tuple[str, int, int] | None:
        """``(backend, tile_b, n_slots)`` of the entry under ``key``, or
        None; counted as a hit or a miss. What every tuned lookup runs."""
        c = self._choices.get(key)
        if c is None:
            e = self.entries.get(key)
            if e is None:
                self.misses += 1
                return None
            c = self._choices[key] = _choice(e)
        self.hits += 1
        return c

    def record(self, sig: CallSignature, *, backend: str, tile_b: int,
               n_slots: int, timings: dict | None = None) -> None:
        entry = {"path": sig.path, "backend": backend,
                 "tile_b": int(tile_b), "n_slots": int(n_slots)}
        if timings:
            entry.update(timings)
        key = sig.key()
        self.entries[key] = entry
        self._choices.pop(key, None)

    def decisions(self) -> dict[str, Decision]:
        """key -> Decision for every entry (the round-trip test surface)."""
        return {k: Decision(*_choice(e), source="cache")
                for k, e in self.entries.items()}

    def to_doc(self) -> dict:
        return {"meta": dict(self.meta),
                "entries": {k: self.entries[k]
                            for k in sorted(self.entries)}}

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_doc(), fh, indent=2)
            fh.write("\n")

    @classmethod
    def from_doc(cls, doc: dict) -> "DispatchCache":
        ver = doc.get("meta", {}).get("version")
        if ver != SCHEMA_VERSION:
            raise ValueError(f"dispatch cache schema version {ver!r} != "
                             f"supported {SCHEMA_VERSION} — regenerate with "
                             f"python -m repro_torch.launch.tune")
        return cls(entries=doc.get("entries", {}), meta=doc.get("meta", {}))

    @classmethod
    def load(cls, path: str) -> "DispatchCache":
        with open(path) as fh:
            return cls.from_doc(json.load(fh))


# ---------------------------------------------------------------------------
# module-level cache: lazy-loaded once, overridable for tests
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_CACHE: DispatchCache | None = None
_LOADED = False


def _repo_root() -> str:
    # src/repro_torch/tune/dispatch.py -> the repo root is above src/
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def default_cache_path() -> str | None:
    """$REPRO_TORCH_TUNE_CACHE (taken verbatim, even if absent — it is
    explicit), else the first existing TUNE_dispatch_cuda.json in (cwd,
    repo root)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    for base in (os.getcwd(), _repo_root()):
        p = os.path.join(base, CACHE_BASENAME)
        if os.path.exists(p):
            return p
    return None


def get_cache() -> DispatchCache:
    """The process-wide cache, loaded lazily from ``default_cache_path()``.
    No file (or an unreadable one) yields an EMPTY cache: every lookup
    misses and the deterministic defaults apply."""
    global _CACHE, _LOADED
    cache = _CACHE
    if _LOADED and cache is not None:       # every lookup after the first
        return cache
    with _LOCK:
        if not _LOADED:
            path = default_cache_path()
            cache = None
            if path and os.path.exists(path):
                try:
                    cache = DispatchCache.load(path)
                except (OSError, ValueError, KeyError, json.JSONDecodeError):
                    cache = None
            _CACHE = cache if cache is not None else DispatchCache()
            _LOADED = True
        return _CACHE


def set_cache(cache: DispatchCache | None) -> None:
    """Install a cache in-process (tests / the autotuner's self-check).
    ``None`` resets to lazy-load-on-next-use."""
    global _CACHE, _LOADED
    with _LOCK:
        _CACHE = cache
        _LOADED = cache is not None


def resolve(path: str, device: str, default_tile_b: int | None = None,
            default_n_slots: int | None = None, *, vocab: int, dim: int,
            batch: int, bag_len, n_fields: int = 1, k_max: int = 1,
            tier_mix: str = "none", bwd_backend: str = "auto",
            default_backend: str | None = None
            ) -> tuple[str, int | None, int | None, bool]:
    """``decide`` as a tuple ``(backend, tile_b, n_slots, hit)``, the form
    every tuned lookup in ``core/embedding`` runs: the key is built without
    a ``CallSignature`` and no ``Decision`` is made."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    c = get_cache().choice(_key(
        path, int(vocab), int(dim), int(batch), bag_len, int(n_fields),
        int(k_max), tier_mix, bwd_backend))
    if c is not None:
        return (*c, True)
    return (default_backend or ("cuda" if device == "cuda" else "torch"),
            default_tile_b, default_n_slots, False)


def decide(path: str, *, vocab: int, dim: int, batch: int, bag_len,
           n_fields: int = 1, k_max: int = 1, tier_mix: str = "none",
           bwd_backend: str = "auto", default_backend: str | None = None,
           default_tile_b: int | None = None,
           default_n_slots: int | None = None,
           device: str = "cpu") -> Decision:
    """Resolve one call signature: the cached decision on a hit; on a miss
    the caller's ``tile_b``/``n_slots`` with ``default_backend``, or the
    ``auto`` rule for tensors on ``device`` (a device type: ``'cuda'`` gives
    ``'cuda'``, anything else ``'torch'``)."""
    backend, tile_b, n_slots, hit = resolve(
        path, device, default_tile_b, default_n_slots, vocab=vocab, dim=dim,
        batch=batch, bag_len=bag_len, n_fields=n_fields, k_max=k_max,
        tier_mix=tier_mix, bwd_backend=bwd_backend,
        default_backend=default_backend)
    return Decision(backend, tile_b, n_slots,
                    source="cache" if hit else "default")
