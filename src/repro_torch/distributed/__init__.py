"""Distributed execution (port of ``repro.distributed``): so far the
single-process fault-tolerance pieces (``fault_tolerance``)."""
