"""The LM side (`repro/models`): the dense family's layers, model,
training and serving steps, and the simLSH softmax.  The moe, ssm,
hybrid, encdec and vlm families raise `NotImplementedError` (ROADMAP
Queue 1 item 9)."""
