"""Distributed execution (port of ``repro.distributed``): so far the
single-process fault-tolerance pieces (``fault_tolerance``) and the host
liveness beacons (``multihost``: ``HeartbeatWriter``, ``HeartbeatMonitor``)."""
