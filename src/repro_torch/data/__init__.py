"""Seeded synthetic CTR and LM token streams (:mod:`.synthetic`) and the
prefetching loader (:mod:`.loader`)."""
