"""Atomic, checksummed, async checkpoints (port of ``repro.checkpoint``)."""
