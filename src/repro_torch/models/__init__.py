"""The LM side (`repro/models`): the dense family's layers, model and
serving steps.  The moe, ssm, hybrid, encdec and vlm families raise
`NotImplementedError` (ROADMAP Queue 1 item 9)."""
