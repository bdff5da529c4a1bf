"""Device resolution, and the one place the port sets float32 matmul precision.

TF32 is off for matrix products and for cuDNN. The JAX package's float32
index path is exact (``ops/topk.py`` ranks by full-f32 scores), and its
encoder runs in float32; TF32 keeps about three decimal digits, which would
reorder near-tied neighbours and break parity with the reference. bfloat16
paths are chosen explicitly (storage and score dtypes), never by a global
precision switch. The port's own f32 kernels use TF32 tensor cores only
through the error-compensated 3xTF32 split (``csrc/scores_bmax_f32_sm90.cu``),
held on the card to at most twice cuBLAS SGEMM's largest error against the
f64 product.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device that does
    not exist. There is no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device!r} does not exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev
