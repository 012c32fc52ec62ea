"""Checkpoints of the training path (the port of ``repro/checkpoint``)."""
