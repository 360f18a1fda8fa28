"""The port's checkpoints (``manager``)."""
