"""Resilience layer of the port (`repro/resil`):

  * `faults`   — deterministic fault injection (the chaos substrate);
  * `validate` — poison-batch quarantine (`PoisonBatchError`) and index
    invariant / recall-smoke validation (`validate_index`);
  * `rebuild`  — background double-buffered index rebuild with a
    validate-then-swap gate and rollback by default (`IndexRebuilder`),
    on its own CUDA stream on the card;
  * `guard`    — divergence watchdog of the online update
    (`DivergenceError`, `GuardConfig`);
  * `wal`      — write-ahead log + crash-safe `OnlineUpdater` whose
    `recover()` replays to a bit-identical `OnlineState`, in the JAX
    package's on-disk format.

Consumers: `serve.service` (admission control, degraded modes, swap),
`core.online` (boundary validation + guard), `train.checkpoint`
(crash-atomic saves).
"""
from repro_torch.resil import faults
from repro_torch.resil.guard import (DivergenceError, GuardConfig,
                                     check_divergence)
from repro_torch.resil.rebuild import IndexRebuilder
from repro_torch.resil.validate import (IndexValidationError,
                                        PoisonBatchError, check_accumulators,
                                        check_delta, check_ids,
                                        check_ingest_batch, validate_index)
from repro_torch.resil.wal import OnlineUpdater, WriteAheadLog

__all__ = [
    "faults", "DivergenceError", "GuardConfig", "check_divergence",
    "IndexRebuilder", "IndexValidationError", "PoisonBatchError",
    "check_accumulators", "check_delta", "check_ids", "check_ingest_batch",
    "validate_index", "OnlineUpdater", "WriteAheadLog",
]
