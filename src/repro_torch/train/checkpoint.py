"""Async, crash-atomic checkpoints in the JAX package's on-disk format
(`repro/train/checkpoint.py`), so a checkpoint written by either package
restores in the other bit for bit.

A step directory ``step-{step:08d}`` holds one ``shard-0.npz`` with the
leaves ``a0, a1, ...`` of a tree in `jax.tree_util`'s order
(`repro_torch.tree`: dict keys sorted, tuples in order, dataclass fields
in order, recursively — `Params`: U, V, b, bh, W, C, mu;
`resil.wal.state_tree`'s flat dict; `launch/train.py`'s
``(params, opt)``), and a ``manifest.json`` written **last**
(``{"step", "nleaves"}``); its presence certifies the step.  Each file
is written to a temp name, fsynced and `os.replace`d, inside a staging
dir ``.tmp-{step}`` whose rename to the step dir is the commit point;
the newest 3 steps are kept.  The read side skips torn step dirs (no
manifest, an unreadable one, a missing or unloadable shard) and falls
back to the newest complete step.

A bfloat16 leaf is written as the JAX package writes one: its raw
2-byte words as a ``|V2`` array, which neither package can restore (the
JAX `restore` raises `TypeError` on it; so does this one, naming the
leaf).

`save` copies every leaf to host memory before it returns and writes on
a background thread; `wait` joins it.  The copies matter: the fit's
packed planes are updated in place, and a CPU tensor's ``.numpy()``
shares their memory, so a checkpoint holding views would hold a later
epoch than its step says.  One process writes one shard (the JAX
package's ``jax.process_index()`` is 0 here).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.resil import faults

SHARD = "shard-0.npz"
KEEP = 3

_save_thread: threading.Thread | None = None


def _host_copy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:        # the JAX package's raw words
            return x.view(torch.int16).numpy().copy().view("V2")
        return x.numpy().copy()
    return np.array(x)


def _replace_write(path: str, write_fn) -> None:
    """Write via temp file + fsync + ``os.replace`` so ``path`` either
    doesn't exist or is complete — never torn."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def wait() -> None:
    """Join the pending save, if any."""
    global _save_thread
    if _save_thread is not None:
        _save_thread.join()
        _save_thread = None


def save(directory: str, tree, *, step: int, sync: bool = False) -> None:
    """Save a tree of tensors and arrays as step ``step`` on a background
    thread (joined first if one is pending; ``sync`` joins this one too)."""
    wait()
    host = [_host_copy(t) for t in T.leaves(tree)]

    def _write():
        tmp = os.path.join(directory, f".tmp-{step}")
        final = os.path.join(directory, f"step-{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        _replace_write(os.path.join(tmp, SHARD),
                       lambda f: np.savez(f, **{f"a{i}": a for i, a in
                                                enumerate(host)}))
        # injected-crash window: shard written, manifest not — readers
        # must treat the resulting dir (if it ever escaped) as torn
        faults.fire("ckpt.save")
        _replace_write(
            os.path.join(tmp, "manifest.json"),
            lambda f: f.write(json.dumps(
                {"step": step, "nleaves": len(host)}).encode()))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # the commit point
        _prune(directory, keep=KEEP)

    global _save_thread
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    _save_thread = t
    if sync:
        wait()


def _prune(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step-"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    # saves are serialized (save() joins the previous writer), so any
    # remaining staging dir is a crash remnant — our own was just renamed
    for d in os.listdir(directory):
        if d.startswith(".tmp-"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def _complete(directory: str, step: int) -> bool:
    """True iff the step dir has a parseable manifest and a loadable shard
    holding every leaf it names."""
    d = os.path.join(directory, f"step-{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            man = json.load(f)
        with np.load(os.path.join(d, SHARD), allow_pickle=False) as data:
            names = set(data.files)
        return all(f"a{i}" in names for i in range(int(man["nleaves"])))
    except (OSError, ValueError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile):
        return False


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step-"):
            try:
                out.append(int(d.split("-")[1]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(directory: str) -> int | None:
    """Newest *complete* step; torn or partial step dirs are skipped."""
    for s in reversed(_steps(directory)):
        if _complete(directory, s):
            return s
    return None


def restore(directory: str, tree_like, *, step: int | None = None):
    """Restore into the structure of ``tree_like`` → (tree, step).  A leaf
    of ``tree_like`` that is a tensor comes back as a tensor on that
    leaf's device, in the dtype it was saved in, and one whose shape
    differs raises `ValueError`; any other leaf (a template's values only
    name the structure, as the JAX package's do) comes back as a host
    numpy array.  A bfloat16 leaf raises `TypeError`.  With ``step=None``
    the newest complete step wins; an explicit torn ``step`` raises."""
    wait()
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under "
                                    f"{directory}")
    elif not _complete(directory, step):
        raise FileNotFoundError(
            f"checkpoint step {step} under {directory} is missing or torn "
            f"(no manifest / unloadable shard) — pass step=None to fall "
            f"back to the newest complete step")
    path = os.path.join(directory, f"step-{step:08d}", SHARD)
    out = []
    with np.load(path, allow_pickle=False) as data:
        for i, (name, like) in enumerate(T.leaves_with_paths(tree_like)):
            a = data[f"a{i}"]
            if a.dtype.kind == "V":
                raise TypeError(
                    f"checkpoint step {step}: leaf {name} holds raw "
                    f"{a.dtype.str} words (a bfloat16 leaf), which neither "
                    f"package restores (ROADMAP.md Queue 3)")
            if not isinstance(like, torch.Tensor):
                out.append(a)
                continue
            if a.shape != tuple(like.shape):
                raise ValueError(f"checkpoint step {step}: leaf {name} "
                                 f"has shape {a.shape}, expected "
                                 f"{tuple(like.shape)}")
            out.append(torch.from_numpy(a).to(like.device))
    return T.unflatten(tree_like, out), step


def try_restore(directory: str, tree_like):
    """`restore`, or None when no complete checkpoint exists."""
    try:
        return restore(directory, tree_like)
    except (FileNotFoundError, OSError):
        return None
