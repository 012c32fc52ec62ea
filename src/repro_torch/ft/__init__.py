"""The fault-tolerant training loop (the port of ``repro/ft``)."""
