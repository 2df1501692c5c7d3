"""Sharding of the port's LM side: the policy's specs (``policy.py``), the
ambient context (``ctx.py``), the placement of modules, states, batches
and caches as DTensors (``place.py``) and attention on a rank's own heads
with the flash-decode over a sequence-sharded cache (``attention.py``)."""
