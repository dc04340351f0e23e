"""The yardstick's arithmetic: the card's peaks and what a kernel call must
move and compute.

Frozen copies of the program's ``chip_smoke.py`` formulas (``measure_k2``,
``measure_k3``, ``phase_kernel_vs_plain``), kept here so that a later
change to the program cannot change how its kernels are judged.

Each function returns ``(bytes, ops)`` for one call: the bytes the call
needs (each input byte read once, each output byte written once) and its
float32 operations. ``bound_s`` turns a list of them into the least time
the card could take.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def k1_call(n_real: int, num_segments: int, width: int,
            elem_bytes: int = 2) -> tuple:
    """K1, the sorted segment sum: reads each real edge's row and its id
    once, writes the float32 [num_segments, width] output once; one add an
    element of a real row (chip_smoke ``phase_kernel_vs_plain``)."""
    nbytes = n_real * width * elem_bytes + 4 * n_real \
        + 4 * num_segments * width
    return nbytes, n_real * width


def k2_call(distinct_rows: int, n_real: int, num_segments: int, width: int,
            elem_bytes: int = 2) -> tuple:
    """K2, the fused gather + segment sum: reads each distinct table row of
    a real edge once, 8 bytes of ids a real edge, writes the float32
    output once (chip_smoke ``measure_k2``)."""
    nbytes = distinct_rows * width * elem_bytes + 8 * n_real \
        + 4 * num_segments * width
    return nbytes, n_real * width


def k3_call(distinct_rows: int, n_ids: int, row_bytes: int) -> tuple:
    """K3, the row gather: each distinct row read once, each output row
    written once, the ids once (chip_smoke ``measure_k3``); no arithmetic."""
    return (distinct_rows + n_ids) * row_bytes + 4 * n_ids, 0


def bound_s(calls) -> float:
    """Least seconds for ``calls`` [(bytes, ops)]: each call bound by the
    larger of its bytes at the HBM rate and its ops at the float32 rate."""
    return sum(max(b / HBM_BYTES_PER_S, o / F32_OPS_PER_S) for b, o in calls)


def matmul_flops(m: int, k: int, n: int) -> int:
    """2 m k n: one multiply and one add an output element and k."""
    return 2 * m * k * n
