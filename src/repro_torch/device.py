"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"``/``"cpu"`` (or a ``torch.device``) → ``torch.device``.

    A CUDA device without a card raises: the port never falls back to the
    CPU on its own, so a run that was meant for the card cannot quietly
    measure something else.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return dev


def grow_segments(dev: torch.device) -> None:
    """Let the CUDA caching allocator grow its segments in place
    (``expandable_segments``) for a training run on ``dev``.  A step whose
    largest activations come and go as blocks of several GiB (an LM head's
    f32 logits over a large vocabulary and a long batch) otherwise splits
    the cache into pieces that no later block of that size fits, and runs
    out of memory with much of the card free.  Does nothing on the CPU or
    where ``PYTORCH_CUDA_ALLOC_CONF`` already names the setting."""
    if dev.type == "cuda" and "expandable_segments" not in os.environ.get(
            "PYTORCH_CUDA_ALLOC_CONF", ""):
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")


def has_data(t: torch.Tensor) -> bool:
    """Whether ``t`` holds values a host read can see: false for a fake
    tensor (``FakeTensorMode``, the dry run's stand-ins) or a meta tensor,
    and for a DTensor whose local shard is one."""
    from torch._subclasses.fake_tensor import is_fake

    return not (t.is_meta or is_fake(t))
