"""Engine of the port: :mod:`.state` (train step, eval step, embed step,
optimizer, metrics) and :class:`.extractor.SpeakerEmbedder`."""
