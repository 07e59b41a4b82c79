"""Serving: the batched LM engine (``lm_engine``)."""
