"""Launchers of the LM substrate (the port of ``repro/launch``): ``serve``,
``train`` and ``solve_serve``."""
