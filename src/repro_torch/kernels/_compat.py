"""Device choice for the port's entry points.

The twin of ``repro/kernels/_compat.py:55-61`` (``on_tpu`` /
``interpret_default``): there the dispatch rule picks Pallas interpret mode
off the TPU; here every entry point runs on the card unless the caller asks
for the CPU, and asking for a card that is not there raises.  Nothing falls
back silently: the plain PyTorch versions of the kernels run only on CPU
tensors, which the caller chose by passing ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev


def refuse_gradient(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires a
    gradient: a forward-only kernel would drop it on the card, so the CPU
    refuses it too."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel (nor has the JAX package's "
            "Pallas kernel): train with attention_impl='plain', the JAX "
            "package's 'xla'")
