"""Where the port's tensors live.

The port runs on the card: every constructor and entry point that takes
`device=None` resolves it here to `cuda:0`, and fails where there is no
card. A caller that wants the CPU (the parity tests do) says
`device="cpu"`; nothing carries on on the CPU by default.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`None` -> cuda:0 (raises without a card); anything else as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "fasttrack_tpu_torch runs on a CUDA device and found none; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", 0)
