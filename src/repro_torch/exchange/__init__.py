"""The ragged sample exchange (:mod:`.ragged`)."""
