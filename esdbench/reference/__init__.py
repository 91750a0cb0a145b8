"""The plain reference of the ESD training step: numpy for dispatch,
the exchange and the cache protocol, plain PyTorch for the model.  It
imports nothing of the program."""
