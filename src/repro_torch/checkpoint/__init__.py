"""Checkpoints of the port's training state (``checkpoint/manager.py``)."""
