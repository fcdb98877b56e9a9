"""The LM side (`repro/models`): every family's layers and model (dense,
moe, ssm, hybrid, encdec, vlm), training and serving steps, and the
simLSH softmax.  The encdec and vlm families serve; their training
raises `NotImplementedError` (ROADMAP Queue 1 item 9.5b)."""
