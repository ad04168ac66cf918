"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    """-> the torch.device to run on; raises if CUDA is asked for and absent.

    There is no silent fallback: a caller that wants the CPU says
    ``device="cpu"``. ``"meta"`` (shapes and dtypes, no storage, nothing
    launched) serves abstract builds only, such as the dry run's
    (``launch/dryrun.py``); it is never a default.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"repro_torch: device {str(device)!r} requested but no CUDA"
                " device is available; pass device='cpu' to run the plain"
                " PyTorch path on the CPU")
        if dev.index is None:   # "cuda" -> "cuda:N", as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu' (or builds"
                         f" abstractly on 'meta'), not {dev}")
    return dev


def as_int32(x, device: torch.device) -> torch.Tensor:
    """numpy array / tensor / nested list -> contiguous int32 tensor on device."""
    t = torch.as_tensor(x)
    if t.dtype != torch.int32:
        t = t.to(torch.int32)
    return t.to(device).contiguous()
