"""The LM side (`repro/models`): every family's layers and model (dense,
moe, ssm, hybrid, encdec, vlm), training and serving steps, and the
simLSH softmax.  Every family serves and trains."""
