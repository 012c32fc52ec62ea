"""Optimizer and compression of the training path (the port of
``repro/optim``): ``adamw`` and ``compress``."""
