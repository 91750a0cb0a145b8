"""The staging plane (:mod:`.prefetch`)."""
