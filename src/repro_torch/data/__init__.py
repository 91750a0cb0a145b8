"""Seeded synthetic CTR streams (:mod:`.synthetic`)."""
