"""Resilience substrate of the port (`repro/resil`): so far the
deterministic fault-injection module, whose only site here is the
checkpoint writer's ``ckpt.save``."""
