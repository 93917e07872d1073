"""Model inputs: the stub modality frontends (:mod:`.pipeline`)."""
