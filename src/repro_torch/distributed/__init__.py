"""Distributed execution (port of ``repro.distributed``): fault tolerance
(``fault_tolerance``), multi-host start-up, barriers, liveness and placement
(``multihost``), the selection mesh and its collectives (``sharding``), and
checksummed int8 / top-k compression (``compression``)."""
