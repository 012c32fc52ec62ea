"""The LM substrate's dense decoder (the port of ``repro/models``):
``layers``, ``attention`` (prefill on the flash kernel, ring KV cache),
``transformer`` and ``convert`` (the reference's weights carried across)."""
