"""Resilience substrate of the port (`repro/resil`): deterministic fault
injection (`faults`, fired at ``ckpt.save`` and ``serve.ingest``), the
boundary checks that quarantine poison batches and refuse corrupt
indexes (`validate`), and the divergence watchdog of the online update
(`guard`).  The background rebuilder and the write-ahead log are a later
slice."""
from repro_torch.resil import faults
from repro_torch.resil.guard import (DivergenceError, GuardConfig,
                                     check_divergence)
from repro_torch.resil.validate import (IndexValidationError,
                                        PoisonBatchError, check_accumulators,
                                        check_delta, check_ids,
                                        check_ingest_batch, validate_index)

__all__ = [
    "faults", "DivergenceError", "GuardConfig", "check_divergence",
    "IndexValidationError", "PoisonBatchError", "check_accumulators",
    "check_delta", "check_ids", "check_ingest_batch", "validate_index",
]
