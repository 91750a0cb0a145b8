"""The staging plane (:mod:`.prefetch`) and the training step's stage
runner (:mod:`.runner`)."""
