"""Device choice for the torch tier.

Replaces ``daft_tpu/device/backend.py`` (the watchdog-guarded PJRT probe):
torch reports a card synchronously, so there is nothing to guard. The rule:
queries run on ``cuda`` unless the caller asks for the CPU, through
``ExecutionConfig.device`` or ``DAFT_TORCH_DEVICE``; ``0`` keeps every
operator on the Arrow host tier. Without a card, a query that did not ask
for the CPU raises — it never quietly runs somewhere else.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import knobs


def resolve_device() -> Optional[torch.device]:
    """The device of this query's fused fragments, or None for the host
    tier. Raises when a CUDA device is asked for and none is present."""
    from ..context import get_context
    spec = get_context().execution_config.device \
        or knobs.env_str("DAFT_TORCH_DEVICE")
    spec = spec.strip().lower()
    if spec in ("0", "host", "off"):
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
