"""Hand-written Hopper kernels (each: ``<name>.py`` wrapper + ``ops.py``
dispatch + ``ref.py`` plain version), built from ``repro_torch/csrc``."""
