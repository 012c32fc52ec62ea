"""Launchers of the LM substrate (the port of ``repro/launch``): ``serve``,
``train`` and ``solve_serve``; the sharded launch layer (``mesh``,
``shardings``, ``specs``, ``variants``) and the fake-mesh dry run with its
roofline terms (``dryrun``, ``roofline``)."""
