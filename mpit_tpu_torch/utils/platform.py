"""Device selection for the port's entry points.

Every entry point runs on CUDA unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  There is no silent fallback: asking
for CUDA on a machine without a card raises, so a result can never be a
CPU number under a device name.

The port computes in full float32, as the JAX reference does.  PyTorch's
default lets cuDNN run float32 convolutions in TF32 (about three decimal
digits), which would make the CNN a different function from the
reference's; :func:`resolve_device` switches TF32 off for convolutions and
matrix products alike.
"""

from __future__ import annotations

import re

import torch


def pin_float32() -> None:
    """Full-float32 convolutions and matrix products on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(name: str | None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device, ``"cuda:i"`` ->
    card ``i`` (raises when there is no such card); ``"cpu"`` -> the CPU.
    Anything else raises."""
    pin_float32()
    card = re.fullmatch(r"cuda:(\d+)", name or "")
    if name in (None, "", "cuda") or card:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "asks for the CPU (--device cpu)"
            )
        if card is None:
            return torch.device("cuda", torch.cuda.current_device())
        index = int(card.group(1))
        if index >= torch.cuda.device_count():
            raise ValueError(f"{name}: this process sees {torch.cuda.device_count()} "
                             "CUDA device(s)")
        return torch.device("cuda", index)
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device must be cuda, cuda:i or cpu, got {name!r}")


def device_name(device: torch.device) -> str:
    """What a result names as the hardware it ran on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
