"""What the plain references share: the sampled subgraph as the reference
reads it, the weights the benchmark makes, the lower-precision control's
rounding, and segment sums in bounded memory.

Plain PyTorch only: nothing here imports the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

CHUNK_EDGES = 1 << 22   # edges a segment sum gathers at once


@dataclass
class Sampled:
    """One sampled batch in plain arrays, sampling order (hop 0 touches the
    seeds). ``n_id`` holds the frontier's global ids in first-seen order;
    ``hops[h] = (src, dst)`` are the real edges of hop h as local ids:
    ``dst`` into level h (``n_id[:level_sizes[h]]``), ``src`` into level
    h + 1. ``caps`` are the node caps of the bucket the program ran the
    batch in (they shape its dropout draws)."""

    n_id: torch.Tensor                    # int64 [level_sizes[-1]]
    level_sizes: List[int]
    hops: List[Tuple[torch.Tensor, torch.Tensor]]
    seeds: torch.Tensor                   # int64 [level_sizes[0]]
    y: torch.Tensor                       # int64 [level_sizes[0]]
    caps: Tuple[int, ...]
    fanouts: Tuple[int, ...]

    def to(self, device) -> "Sampled":
        return Sampled(self.n_id.to(device), list(self.level_sizes),
                       [(s.to(device), d.to(device)) for s, d in self.hops],
                       self.seeds.to(device), self.y.to(device),
                       tuple(self.caps), tuple(self.fanouts))


def make_weights(shapes: Dict[str, tuple], bounds: Dict[str, float],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights, each uniform on (-bound, bound), from one draw of a
    device generator seeded by ``seed``."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 0x2545F4914F6CDD1D + 0x5851F42D) % (2**63 - 1))
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        u = flat[at:at + n].view(shape)
        out[name] = (2.0 * u - 1.0) * bounds[name]
        at += n
    return out


def elem_bytes(cfg: dict) -> int:
    """Bytes of one value in the configuration's compute precision."""
    return {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["compute_dtype"]]


def xavier_bound(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """The control's precision: x rounded to float8 e4m3 with one
    per-tensor scale (its largest magnitude maps to 448), back in float32.
    The rounding passes gradients straight through: the backward's
    products see the rounded operands, the gradients themselves stay in
    float32."""
    d = x.detach()
    s = d.abs().amax().clamp_min(1e-30) / 448.0
    q = (d / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - d)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def rounding(precision: str):
    """The rounding the reference applies wherever the program holds a
    tensor in its compute precision (the operands of each product and
    aggregation, the attention logits, the last layer's logits): none in
    float32, ``fp8_round`` in the control."""
    if precision == "float32":
        return identity
    if precision == "fp8":
        return fp8_round
    raise ValueError(f"precision {precision!r}: float32 or fp8")


def segment_sum(rows: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                num_segments: int,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[t] = sum over edges e with dst[e] == t of weight[e] * rows[src[e]]
    in float32, gathering at most CHUNK_EDGES rows at once."""
    out = rows.new_zeros(num_segments, rows.shape[1])
    for a in range(0, src.shape[0], CHUNK_EDGES):
        msg = rows.index_select(0, src[a:a + CHUNK_EDGES])
        if weight is not None:
            msg = msg * weight[a:a + CHUNK_EDGES, None]
        out = out.index_add(0, dst[a:a + CHUNK_EDGES], msg)
    return out


def degrees(dst: torch.Tensor, num_segments: int) -> torch.Tensor:
    return torch.bincount(dst, minlength=num_segments).to(torch.float32)


def step_seed(seed: int, step: int) -> int:
    """The per-step dropout seed rule the program documents (its train
    state reseeds the dropout generator with it before each step)."""
    s = (seed * 0x9E3779B97F4A7C15 + (step + 1) * 0xBF58476D1CE4E5B9) \
        & (2**64 - 1)
    s ^= s >> 31
    return s & (2**63 - 1)


def dropout_masks(seed: int, step: int, shapes, p: float,
                  device) -> List[torch.Tensor]:
    """The keep masks, scaled by 1 / (1 - p), of one step's dropout layers
    in order: flax's rule (keep where a uniform draw is >= p), drawn from
    the step's generator at the shapes the program drew them."""
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, step))
    return [(torch.rand(s, generator=gen, device=device) >= p).float()
            / (1.0 - p) for s in shapes]


def adam_update(params, grads, m, v, t: int, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step in place (bias-corrected moments, no weight decay)."""
    with torch.no_grad():
        for k in params:
            m[k].mul_(b1).add_(grads[k], alpha=1 - b1)
            v[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
            mh = m[k] / (1 - b1 ** t)
            vh = v[k] / (1 - b2 ** t)
            params[k] -= lr * mh / (vh.sqrt() + eps)
