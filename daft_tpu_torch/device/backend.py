"""Device choice for the torch tier.

Replaces ``daft_tpu/device/backend.py`` (the watchdog-guarded PJRT probe):
torch reports a card synchronously, so there is nothing to guard. The rule:
queries run on ``cuda`` unless the caller asks for the CPU, through
``ExecutionConfig.device`` or ``DAFT_TORCH_DEVICE``; ``0`` keeps every
operator on the Arrow host tier. Without a card, a query that did not ask
for the CPU raises — it never quietly runs somewhere else.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import knobs


def device_spec() -> str:
    """The asked-for device as written (``ExecutionConfig.device``, else
    ``DAFT_TORCH_DEVICE``), normalized; nothing is probed."""
    from ..context import get_context
    spec = get_context().execution_config.device \
        or knobs.env_str("DAFT_TORCH_DEVICE")
    return spec.strip().lower()


def host_tier_only() -> bool:
    """True when the caller asked for the host tier (``0``)."""
    return device_spec() in ("0", "host", "off")


def resolve_device() -> Optional[torch.device]:
    """The device of this query's fused fragments, or None for the host
    tier. Raises when a CUDA device is asked for and none is present."""
    spec = device_spec()
    if host_tier_only():
        return None
    if spec == "cpu":
        return torch.device("cpu")
    if spec.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "daft_tpu_torch: no CUDA device is available; ask for the "
                "CPU explicitly (DAFT_TORCH_DEVICE=cpu or "
                "set_execution_config(device='cpu'))")
        return torch.device(spec)
    raise ValueError(f"DAFT_TORCH_DEVICE={spec!r}: expected cuda, cpu or 0")


def is_accelerator(device: Optional[torch.device] = None) -> bool:
    """True when ``device`` (by default this query's, :func:`resolve_device`)
    is a CUDA card: the hash kernels are compiled for it. The reference's
    ``_hash_capable_backend`` rule: on CPU tensors the kernels' plain
    versions stand in, for parity, not speed."""
    if device is None:
        device = resolve_device()
    return device is not None and device.type == "cuda"


def device_key(device: Optional[torch.device]) -> str:
    """The name a measured profile is stored under: the card's name and
    the host's (chip runs land on different machines), or ``cpu``."""
    if device is None or device.type != "cuda":
        return "cpu"
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _card_key(idx)


@functools.lru_cache(maxsize=None)
def _card_key(index: int) -> str:
    import socket
    return f"{torch.cuda.get_device_name(index)}@{socket.gethostname()}"
