"""fp8 (e4m3) row codec of the host cold tier (counterpart of the fp8
part of the JAX package's ``parallel/exchange.py``; the feature exchange
itself comes with the multi-GPU slice).

Rows are scaled to an amax of 448, the largest finite e4m3 value, and
cast; each row keeps its float32 dequant scale ``amax / 448``. torch's
float32 → ``float8_e4m3fn`` cast rounds to nearest even, as ml_dtypes'
does, so the payload bytes equal the JAX package's. The two differ only
above |464|, where torch saturates to 448 and ml_dtypes gives NaN; rows
scaled to amax 448 never reach it.
"""

from __future__ import annotations

import numpy as np
import torch

_FP8_MAX = 448.0  # float8_e4m3fn largest finite


def wire_row_bytes(num_features: int, dtype, wire_fp8: bool) -> int:
    """Bytes a feature row takes on the wire: fp8 ships one byte an
    element plus the float32 row scale."""
    if wire_fp8:
        return num_features + 4
    return num_features * torch.empty((), dtype=dtype).element_size()


def fp8_encode_rows_np(x: np.ndarray):
    """Host-side one-time fp8 (e4m3) row encoding: (uint8 payload [N, F],
    float32 dequant scale [N]). Decode with :func:`fp8_decode_rows`."""
    xf = np.asarray(x, np.float32)
    amax = np.abs(xf).max(axis=1)
    # masked divide (np.where would still evaluate _FP8_MAX / 0 and warn)
    q_scale = np.ones_like(amax, np.float32)
    np.divide(_FP8_MAX, amax, out=q_scale, where=amax > 0)
    scaled = torch.from_numpy(np.ascontiguousarray(xf * q_scale[:, None]))
    payload = scaled.to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    return payload, (amax / _FP8_MAX).astype(np.float32)


def fp8_decode_rows(rows_u8: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Decode :func:`fp8_encode_rows_np` payloads on the tensors' device:
    the bytes as e4m3, to float32, times the row scale, then ``dtype``."""
    rows = rows_u8.view(torch.float8_e4m3fn).to(torch.float32)
    return (rows * scale[:, None]).to(dtype)
