"""ESD core: Alg. 1 and Alg. 2 on the host (numpy, serving) and on the
device (PyTorch, the training step's decide stage and cache state)."""
