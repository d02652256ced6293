"""Sharded, atomic, versioned checkpoints (the twin of ``repro.checkpoint``)."""
