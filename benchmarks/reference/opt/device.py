"""Device and precision policy of the port.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with
no GPU and no device given they raise instead of running on the CPU.

On the card every float stage runs in float32 with TF32 off for both
matrix products and cuDNN: reduced-precision products quantize depths
enough to break the boundary-cut thresholds (README, "Numerics"), and
PyTorch runs float32 convolutions in TF32 by default.
"""

from __future__ import annotations

import torch


def set_cuda_precision() -> None:
    """Full float32 for matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU; without one this raises rather than falling
    back to the CPU. A CUDA device also gets the float32 policy above, and
    an index (``"cuda"`` -> ``cuda:<current>``), so it compares equal to a
    tensor's ``.device``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        set_cuda_precision()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    """The card's name (`torch.cuda.get_device_name`), or "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
