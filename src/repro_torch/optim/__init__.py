"""Optimizers and learning-rate schedules (port of ``repro.optim``)."""
