"""Import shim: the LM decode engine lives in ``serve.lm_engine``.

``repro_torch.serve`` hosts two engines — the batched LM prefill/decode
engine (``lm_engine``) and the selection-serving subsystem
(``store``/``buffers``/``server``: the multi-tenant ``MiloServer``).  The
``serve.engine`` path resolves to the LM engine, as the reference's does.
"""
from repro_torch.serve.lm_engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
