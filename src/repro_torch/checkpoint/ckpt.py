"""Checkpointing: atomic step-numbered saves, an async writer thread, and
elastic re-partition of banked tables (the port of
``repro/checkpoint/ckpt.py``).

Layout, the reference's exactly:  <dir>/step_<n>.tmp/ -> rename to
<dir>/step_<n>/, one ``leaf_<i>.npy`` per leaf and a ``tree.json`` manifest
``{"step", "leaves": [{"path", "index", "dtype", "shape"}]}``. Paths are
JAX's ``keystr`` spelling (``.params['emb_packed']``,
``.opt_state['false']['v'][0]``, ``.step``): dataclass fields as
``.name``, dict keys in sorted order as ``['key']``, list and tuple items
as ``[i]``, None as no leaf. So a checkpoint written by either package
restores in the other. Atomic rename means a crash mid-save never
corrupts the latest checkpoint: restore picks the highest COMPLETE step.

bfloat16 leaves: numpy knows bf16 only through ``ml_dtypes``, so the
reference's files hold them as raw 2-byte voids (``V2``) under a manifest
dtype of ``"bfloat16"``. The port writes the same (the bits as ``V2``) and
reads either back through an int16 view.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(keystr path, leaf)] in JAX's pytree order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in _flatten(getattr(tree, f.name),
                                   f"{prefix}.{f.name}")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def _unflatten(like, it):
    """A tree of ``like``'s structure holding the next leaves of ``it``."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), it)
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, it) for x in like)
    if like is None:
        return None
    return next(it)


def _to_host(leaf) -> np.ndarray:
    """A leaf as a host numpy array it owns: a tensor copied off its device
    (bf16 as its bits, viewed ``V2``), anything else through ``np.array``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).to("cpu", copy=True).numpy().view("V2")
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _dtype_name(arr: np.ndarray, leaf) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A stored leaf as a tensor on ``device``. bf16 is the manifest's
    ``"bfloat16"``, or raw 2-byte voids under a ``"|V2"`` manifest dtype:
    what the reference writes when it saves a bf16 leaf it restored."""
    arr = np.require(arr, requirements="C")      # keeps 0-d arrays 0-d
    if dtype == "bfloat16" or (arr.dtype.kind == "V"
                               and arr.dtype.itemsize == 2):
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    if arr.dtype.name != dtype:
        raise ValueError(f"leaf stored as {arr.dtype}, manifest says {dtype}")
    return torch.from_numpy(arr).to(device)


def _write(ckpt_dir: str, step: int, named: list[tuple[str, np.ndarray,
                                                       str]]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = []
    for i, (path, arr, dtype) in enumerate(named):
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest.append({"path": path, "index": i, "dtype": dtype,
                         "shape": list(arr.shape)})
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _host_leaves(tree) -> list[tuple[str, np.ndarray, str]]:
    out = []
    for path, leaf in _flatten(tree):
        arr = _to_host(leaf)
        out.append((path, arr, _dtype_name(arr, leaf)))
    return out


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` (tensors on any device, or numpy) as ``step_<step>``
    under ``ckpt_dir``; returns the step's directory."""
    return _write(ckpt_dir, step, _host_leaves(tree))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "tree.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, target_tree, step: int | None = None):
    """Restore into the STRUCTURE of ``target_tree`` (shapes may differ for
    banked tables: use ``reshard_banked_table`` afterwards for elastic
    changes). Returns ``(tree, step)``: each leaf a tensor in the
    manifest's dtype, on the device of the target's leaf at its path (the
    CPU where the target's leaf is not a tensor). ``step`` None: the latest
    complete step, or FileNotFoundError when there is none."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "tree.json")) as f:
        manifest = json.load(f)
    by_path = {m["path"]: m for m in manifest["leaves"]}
    out = []
    for path, tgt in _flatten(target_tree):
        m = by_path.get(path)
        if m is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = np.load(os.path.join(d, f"leaf_{m['index']}.npy"))
        dev = tgt.device if isinstance(tgt, torch.Tensor) else "cpu"
        out.append(_from_host(arr, m["dtype"], dev))
    return _unflatten(target_tree, iter(out)), step


class AsyncCheckpointer:
    """Fire-and-forget saves on a writer thread; ``join()`` before exit.

    The device -> host copy happens on the caller's thread (the host arrays
    are the writer's own afterwards); disk IO overlaps the next train
    steps. ``stats`` records each save: its step, the seconds of the host
    copy and of the write, and the bytes written."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.stats: list[dict] = []
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree) -> None:
        t0 = time.perf_counter()
        named = _host_leaves(tree)
        rec = {"step": step, "host_s": time.perf_counter() - t0,
               "nbytes": sum(a.nbytes for _, a, _ in named)}
        self.join()
        self.stats.append(rec)
        self._thread = threading.Thread(
            target=self._write, args=(step, named, rec), daemon=True)
        self._thread.start()

    def _write(self, step: int, named, rec: dict) -> None:
        t0 = time.perf_counter()
        _write(self.ckpt_dir, step, named)
        self._gc()
        rec["write_s"] = time.perf_counter() - t0

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.ckpt_dir))
            if m)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def reshard_banked_table(packed: np.ndarray, old_plan, new_plan) -> np.ndarray:
    """Elastic re-partition: packed rows under ``old_plan`` -> packed under
    ``new_plan`` (bank count or balance changed: a node failure or a
    scale-out).

    Rows are addressed logically (vocab ids), so the migration is two
    gathers; padding rows are dropped or re-created as zeros."""
    dim = packed.shape[1]
    old_rows = int(old_plan.max_rows_per_bank)
    new_rows = int(new_plan.max_rows_per_bank)
    vocab = old_plan.vocab
    assert new_plan.vocab == vocab
    flat_old = old_plan.bank_of_row.astype(np.int64) * old_rows \
        + old_plan.slot_of_row
    logical = packed[flat_old]                      # (vocab, dim)
    out = np.zeros((new_plan.n_banks * new_rows, dim), packed.dtype)
    flat_new = new_plan.bank_of_row.astype(np.int64) * new_rows \
        + new_plan.slot_of_row
    out[flat_new] = logical
    return out
