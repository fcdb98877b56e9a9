"""Write-ahead log + crash-safe wrapper for the Alg.-4 online path
(`repro/resil/wal.py`).

`core.online.online_update` builds a new state from the old one (it
never writes the input's tensors), which makes crash safety a logging
problem, not a locking problem:

  1. **append** the ΔΩ triples, the prng key, and the static update
     arguments to the WAL (atomic: temp file + ``os.replace``, one file
     per entry, so a torn append is invisible);
  2. apply the update in memory;
  3. every ``ckpt_every`` updates, **checkpoint** the full `OnlineState`
     through `train.checkpoint` (itself crash-atomic) and prune WAL
     entries the checkpoint now covers.

A crash anywhere in (2)–(3) loses only process memory.  `recover()`
restores the newest complete checkpoint and **replays** every WAL entry
past it through the same `online_update` — same state, same triples,
same key, and every colliding scatter added in index order
(`core.scatter.index_add_det_`, on the card as on the CPU) ⇒ the
recovered `OnlineState` is **bit-identical** to what an uninterrupted run
on the same device would hold.  Entries that tripped the divergence
guard live re-trip identically on replay and stay rejected, so guard
rollbacks are replay-stable too.

The WAL stores *inputs*, not states: an entry is a few KB of triples
versus the full factor planes, so logging cost is O(|ΔΩ|) per update and
the checkpoint cadence alone controls recovery time.

The files are the JAX package's: ``wal-{seq:012d}.npz`` entries holding
``rows``, ``cols``, ``vals`` and the key's ``uint32[2]`` words beside a
``__meta__`` JSON (``K``, ``epochs``, ``batch``, ``lsh`` and ``hp`` as
`dataclasses.asdict` — the two packages' `SimLSHConfig` and `Hyper` have
the same fields — ``M_new``, ``N_new``, ``seq``), and checkpoints of the
`state_tree` dict in `train.checkpoint`'s format.  A log either package
wrote replays in the other.  Entries with a ``kind`` (the always-on
loop's slices) are refused: the loop's own recovery replays them.

Fault-injection sites: ``wal.append`` (before an entry is written) and
``online.update`` (after it is logged, before it is applied).
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.model import Params
from repro_torch.data.sparse import SparseMatrix
from repro_torch.device import resolve_device
from repro_torch.resil import faults
from repro_torch.resil.guard import DivergenceError, GuardConfig
from repro_torch.train import checkpoint

_PREFIX = "wal-"
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class WalEntry:
    seq: int
    arrays: dict      # rows, cols, vals, key (host numpy)
    meta: dict        # M_new, N_new, K, epochs, batch, lsh, hp, seq


class WriteAheadLog:
    """One ``wal-{seq:012d}.npz`` per entry under ``directory``.  Appends
    are atomic (temp + ``os.replace``); readers therefore never see a
    torn entry — a crash mid-append leaves only a ``.tmp-`` file, which
    is ignored and cleaned lazily."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, seq: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{seq:012d}.npz")

    def seqs(self) -> list:
        out = []
        for f in os.listdir(self.directory):
            if f.startswith(_PREFIX) and f.endswith(".npz"):
                try:
                    out.append(int(f[len(_PREFIX):-4]))
                except ValueError:
                    continue
        return sorted(out)

    def last_seq(self) -> int:
        s = self.seqs()
        return s[-1] if s else 0

    def append(self, seq: int, arrays: dict, meta: dict) -> str:
        faults.fire("wal.append")
        final = self._path(seq)
        if os.path.exists(final):
            raise ValueError(f"WAL entry {seq} already exists — sequence "
                             f"numbers must be unique and increasing")
        tmp = os.path.join(self.directory, f".tmp-{seq:012d}-{os.getpid()}")
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta),
                     **{k: _host(v) for k, v in arrays.items()})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        return final

    def read(self, seq: int) -> WalEntry:
        with np.load(self._path(seq), allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            arrays = {k: data[k] for k in data.files if k != "__meta__"}
        return WalEntry(seq=seq, arrays=arrays, meta=meta)

    def entries(self, after: int = 0) -> list:
        """All entries with seq > ``after``, ascending — the redo set."""
        return [self.read(s) for s in self.seqs() if s > after]

    def prune(self, upto: int) -> int:
        """Drop entries with seq ≤ ``upto`` (covered by a checkpoint) and
        any stale temp files.  Returns how many entries were removed."""
        n = 0
        for s in self.seqs():
            if s <= upto:
                os.remove(self._path(s))
                n += 1
        for f in os.listdir(self.directory):
            if f.startswith(".tmp-"):
                try:
                    os.remove(os.path.join(self.directory, f))
                except OSError:
                    pass
        return n


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def key_words(key) -> np.ndarray:
    """A prng key (the port's int64 ``[2]`` tensor, or the JAX package's
    ``uint32[2]`` words) → ``uint32[2]`` words, the logged form."""
    return (_host(key).astype(np.int64) & _M32).astype(np.uint32)


def _key_tensor(words) -> torch.Tensor:
    """Logged ``uint32[2]`` words → the port's key (on the CPU)."""
    return torch.from_numpy(np.asarray(words).astype(np.int64))


# ---------------------------------------------------------------------------
# OnlineState <-> checkpoint tree
# ---------------------------------------------------------------------------

_PARAM_FIELDS = ("U", "V", "b", "bh", "W", "C", "mu")


def state_tree(st) -> dict:
    """`OnlineState` → flat dict for `train.checkpoint` (saved in sorted key
    order, as the JAX package's pytree).  M/N/shape are recovered from
    array shapes; ``stats`` is transient and deliberately not persisted;
    the key is stored as its ``uint32[2]`` words."""
    if st.hash_key is None:
        raise ValueError("OnlineState.hash_key is unset — a state without "
                         "its Φ-family key cannot be restored usefully")
    tree = {f: getattr(st.params, f) for f in _PARAM_FIELDS}
    tree.update(S=st.S, JK=st.JK, sp_rows=st.sp.rows, sp_cols=st.sp.cols,
                sp_vals=st.sp.vals, hash_key=key_words(st.hash_key))
    return tree


def state_from_tree(tree: dict, device):
    """A restored tree (arrays or tensors) → `OnlineState` on ``device``;
    the key stays on the CPU, as the fit's keys do."""
    from repro_torch.core.online import OnlineState   # cycle: wal ← online
    dev = torch.device(device)
    on = lambda a, dtype: torch.as_tensor(
        _host(a), dtype=dtype).to(dev)
    params = Params(**{f: on(tree[f], torch.float32) for f in _PARAM_FIELDS})
    M, N = int(params.U.shape[0]), int(params.V.shape[0])
    sp = SparseMatrix(on(tree["sp_rows"], torch.int32),
                      on(tree["sp_cols"], torch.int32),
                      on(tree["sp_vals"], torch.float32), (M, N))
    return OnlineState(params=params, S=on(tree["S"], torch.float32),
                       JK=on(tree["JK"], torch.int32), sp=sp, M=M, N=N,
                       hash_key=_key_tensor(tree["hash_key"]))


def _template() -> dict:
    keys = _PARAM_FIELDS + ("S", "JK", "sp_rows", "sp_cols", "sp_vals",
                            "hash_key")
    return {k: 0 for k in keys}     # structure only; leaves are replaced


# ---------------------------------------------------------------------------
# the crash-safe updater
# ---------------------------------------------------------------------------


class OnlineUpdater:
    """WAL-logged, checkpointed, divergence-guarded `online_update` loop.

    Layout under ``root``: ``root/wal/`` (redo log) and ``root/ckpt/``
    (crash-atomic `train.checkpoint` steps, step number = update seq).

    The static update arguments (lsh config, hyper-params, K, epochs,
    batch) are fixed per updater — they are part of the replay contract,
    so `recover` takes the same constructor arguments and refuses meta
    that disagrees with what an entry was logged with.  The state lives
    where ``state``'s parameters do.
    """

    def __init__(self, state, lsh, hp, *, root: str, K: int,
                 epochs: int = 3, batch: int = 4096, ckpt_every: int = 4,
                 guard: GuardConfig | None = GuardConfig(),
                 registry: obs.Registry | None = None,
                 _seq: int = 0, _ckpt_seq: int = 0):
        self.state = state
        self.lsh, self.hp = lsh, hp
        self.K, self.epochs, self.batch = K, epochs, batch
        self.ckpt_every = ckpt_every
        self.guard = guard
        self.obs = registry if registry is not None else obs.scoped()
        self.root = root
        self.wal = WriteAheadLog(os.path.join(root, "wal"))
        self.ckpt_dir = os.path.join(root, "ckpt")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.seq = _seq
        self._ckpt_seq = _ckpt_seq

    def _static_meta(self) -> dict:
        return dict(K=self.K, epochs=self.epochs, batch=self.batch,
                    lsh=dataclasses.asdict(self.lsh),
                    hp=dataclasses.asdict(self.hp))

    def update(self, new_rows, new_cols, new_vals, key, *,
               M_new: int, N_new: int):
        """Validate → WAL append → apply → (periodic) checkpoint.

        Raises `PoisonBatchError` *before* logging (quarantined batches
        never enter the redo log) and `DivergenceError` *after* logging
        (the guard rollback is replay-stable — see module docstring); in
        both cases ``self.state`` is unchanged.  ``key`` is a port key or
        the JAX package's ``uint32[2]`` words."""
        from repro_torch.core.online import online_update
        from repro_torch.resil.validate import check_delta
        # quarantine before logging: a poison batch must not enter the redo
        # log, or recovery would replay the rejection forever
        check_delta(new_rows, new_cols, new_vals, M_new=M_new, N_new=N_new,
                    M_old=self.state.M, N_old=self.state.N)
        seq = self.seq + 1
        words = key_words(key)
        meta = dict(self._static_meta(), M_new=M_new, N_new=N_new, seq=seq)
        with self.obs.span("resil.wal.append"):
            self.wal.append(seq, dict(rows=new_rows, cols=new_cols,
                                      vals=new_vals, key=words), meta)
        self.obs.counter_add("resil.wal.appends")
        faults.fire("online.update")      # the crash-mid-ingest window
        try:
            st2 = online_update(self.state, new_rows, new_cols, new_vals,
                                self.lsh, self.hp, _key_tensor(words),
                                M_new=M_new, N_new=N_new, K=self.K,
                                epochs=self.epochs, batch=self.batch,
                                guard=self.guard, registry=self.obs)
        except DivergenceError:
            # rejected update: seq still advances (the entry is logged and
            # will re-trip on replay), state stays rolled back
            self.seq = seq
            self.obs.counter_add("resil.guard_trips")
            raise
        self.state, self.seq = st2, seq
        if seq - self._ckpt_seq >= self.ckpt_every:
            self.checkpoint()
        return self.state

    def checkpoint(self) -> None:
        """Durable cut: crash-atomic state checkpoint at the current seq,
        then prune the WAL entries it covers."""
        with self.obs.span("resil.ckpt"):
            checkpoint.save(self.ckpt_dir, state_tree(self.state),
                            step=self.seq, sync=True)
        self.wal.prune(self.seq)
        self._ckpt_seq = self.seq
        self.obs.counter_add("resil.ckpts")

    @classmethod
    def recover(cls, root: str, lsh, hp, *, K: int, epochs: int = 3,
                batch: int = 4096, base_state=None, ckpt_every: int = 4,
                guard: GuardConfig | None = GuardConfig(),
                registry: obs.Registry | None = None,
                device=None) -> "OnlineUpdater":
        """Rebuild the pre-crash updater: newest complete checkpoint (torn
        steps are skipped by `train.checkpoint`) + WAL replay of every
        entry past it.  ``base_state`` seeds a run that crashed before its
        first checkpoint (required then; ignored when a checkpoint
        exists).  A restored checkpoint lands on ``device``: by default
        ``base_state``'s device when one is given, else the card."""
        from repro_torch.core.online import online_update
        reg = registry if registry is not None else obs.scoped()
        if device is None and base_state is not None:
            device = base_state.params.U.device
        ckpt_dir = os.path.join(root, "ckpt")
        restored = checkpoint.try_restore(ckpt_dir, _template())
        if restored is not None:
            tree, step = restored
            state = state_from_tree(tree, resolve_device(device))
        elif base_state is not None:
            state, step = base_state, 0
        else:
            raise FileNotFoundError(
                f"no complete checkpoint under {ckpt_dir} and no "
                f"base_state to replay from")
        up = cls(state, lsh, hp, root=root, K=K, epochs=epochs, batch=batch,
                 ckpt_every=ckpt_every, guard=guard, registry=reg,
                 _seq=step, _ckpt_seq=step)
        want = dict(K=K, epochs=epochs, batch=batch,
                    lsh=dataclasses.asdict(lsh), hp=dataclasses.asdict(hp))
        for e in up.wal.entries(after=step):
            if e.meta.get("kind") is not None:
                raise ValueError(
                    f"WAL entry {e.seq} is a {e.meta['kind']!r} entry "
                    f"written by the always-on loop — OnlineUpdater.recover "
                    f"replays only online_update entries; the loop's own "
                    f"recovery also replays micro-epochs and loop cursors")
            for k, v in want.items():
                if e.meta.get(k) != v:
                    raise ValueError(
                        f"WAL entry {e.seq} was logged with {k}="
                        f"{e.meta.get(k)!r} but recover() got {v!r} — "
                        f"replay with the original static arguments")
            with reg.span("resil.wal.replay"):
                try:
                    up.state = online_update(
                        up.state, e.arrays["rows"], e.arrays["cols"],
                        e.arrays["vals"], lsh, hp,
                        _key_tensor(e.arrays["key"]),
                        M_new=e.meta["M_new"], N_new=e.meta["N_new"],
                        K=K, epochs=epochs, batch=batch, guard=guard,
                        registry=reg)
                except DivergenceError:
                    reg.counter_add("resil.guard_trips")   # replay-stable
            up.seq = e.seq
            reg.counter_add("resil.wal.replayed")
        return up
