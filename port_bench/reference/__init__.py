"""The benchmark's plain reference of SipMask: the model, the loss, the
decode and the training step, in plain PyTorch. It imports nothing of the
program under test."""
