#!/usr/bin/env python3
"""Time K1 and K2 with other slice sizes and unroll depths on one NVIDIA GPU.

    python3 tools/tune_segment_slice.py [--slices 32,64,128] [--unrolls 8,16]
                                        [--min-blocks 2,3]

K1 (``csrc/sorted_segment_sum.cu``) and K2 (``csrc/fused_gather_segment_sum.cu``)
share ``csrc/segment_common.cuh``, whose ``kSlice`` (edges a worker owns),
``kUnroll`` (row loads in flight a lane) and ``kMinBlocks`` (pass-1 blocks
an SM must hold, which caps the registers) are constants of the source.
This script copies the sources into a temporary directory once per
variant, rewrites the three constants, builds each copy with nvcc and calls its C
entry points directly (scratch sized for that slice), at the shapes of
``chip_smoke.py``'s phase 3: K1's four calls of one bench-shape train step,
K2 at the step's layer 0 and at a hub and a typical chunk of layerwise
inference (F = 128 and 256). Every output is held against the plain
version (bf16 inputs, rtol 1e-2) before it is timed. It prints one line a
variant with the time of each call (CUDA events, ms) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from salient_plusplus_tpu_torch.native import build  # noqa: E402
from salient_plusplus_tpu_torch.ops import pallas_aggregate as A  # noqa: E402
from salient_plusplus_tpu_torch.ops import sorted_segment as S  # noqa: E402

CSRC = os.path.join(ROOT, "salient_plusplus_tpu_torch", "csrc")
NAMES = ("sorted_segment_sum", "fused_gather_segment_sum")
ARGTYPES = {"sorted_segment_sum": S._ARGTYPES,
            "fused_gather_segment_sum": A._ARGTYPES}


def build_variant(tmp: str, C: int, U: int, MB: int) -> dict:
    """The two entry points built with kSlice = C, kUnroll = U and
    kMinBlocks = MB."""
    d = os.path.join(tmp, f"c{C}u{U}b{MB}")
    os.makedirs(d)
    with open(os.path.join(CSRC, "segment_common.cuh")) as f:
        hdr = f.read()
    for name, v in (("kSlice", C), ("kUnroll", U), ("kMinBlocks", MB)):
        hdr, n = re.subn(rf"{name} = \d+;", f"{name} = {v};", hdr)
        if n != 1:
            raise RuntimeError(f"{name} not found in the header")
    with open(os.path.join(d, "segment_common.cuh"), "w") as f:
        f.write(hdr)
    fns, regs, spills = {}, [], 0
    for name in NAMES:
        src = shutil.copy(os.path.join(CSRC, f"{name}.cu"), d)
        lib = os.path.join(d, f"lib{name}.so")
        res = subprocess.run([build._nvcc(), "-gencode",
                              "arch=compute_90a,code=sm_90a", "-std=c++17",
                              "-O3", "-shared", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v", "-I", d, "-o", lib, src],
                             check=True, capture_output=True, text=True)
        regs += [int(r) for r in re.findall(r"Used (\d+) registers",
                                            res.stderr)]
        spills += sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                                 res.stderr))
        fn = getattr(ctypes.CDLL(lib), f"sptpu_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [*ARGTYPES[name], ctypes.c_void_p]
        fns[name] = fn
    fns["ptxas"] = f"registers {min(regs)}-{max(regs)}, spill stores {spills} B"
    return fns


def call(fn, C, rows, ids, T, src=None, count=None):
    E, F = ids.shape[0], rows.shape[1]
    out = torch.empty(T, F, dtype=torch.float32, device=rows.device)
    scratch = torch.empty(2 * -(-E // C) * (-(-F // 4) * 4),
                          dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream().cuda_stream
    code = A._DTYPE_CODE[rows.dtype]
    if src is None:
        args = (rows.data_ptr(), code, ids.data_ptr(), E, T, F)
    else:
        args = (rows.data_ptr(), code, src.data_ptr(), ids.data_ptr(),
                count.data_ptr(), E, T, F)
    rc = fn(*args, out.data_ptr(), scratch.data_ptr(), scratch.numel(),
            stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError {rc}")
    return out


def main_path_calls(dev):
    """(label, kernel, kwargs, plain()) at chip_smoke's phase-3 shapes."""
    from salient_plusplus_tpu_torch.models.inference import LocalEngine
    from salient_plusplus_tpu_torch.ops.segment import gather_rows

    trainer = cs.bench_trainer(dev)
    batch = cs.bench_batch(trainer, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    calls = []
    for label, ids, T, F, n in cs.k1_cases(trainer, batch):
        vals = torch.randn(ids.shape[0], F, generator=g, device=dev).to(
            torch.bfloat16)
        calls.append((f"K1 {label}", "sorted_segment_sum",
                      dict(rows=vals, ids=ids, T=T)))
    e0 = batch.edges[0]
    calls.append(("K2 step layer 0", "fused_gather_segment_sum",
                  dict(rows=trainer.features, ids=e0.dst,
                       T=batch.layer_caps(0)[1], src=e0.src,
                       count=torch.as_tensor(e0.count, dtype=torch.int32,
                                             device=dev))))
    V = trainer.features.shape[0]
    eng = LocalEngine(trainer.graph.rowptr, trainer.graph.col,
                      cs.LAYERWISE_CHUNK, dev)
    wide = torch.randn(V, 256, generator=g, device=dev).to(torch.bfloat16)
    for where, s in (("hub", 0), ("typical", V // 2 // cs.LAYERWISE_CHUNK
                                  * cs.LAYERWISE_CHUNK)):
        n_id, edge, n = eng.chunk(s)
        for emb in (trainer.features, wide):
            calls.append((f"K2 {where} F{emb.shape[1]}",
                          "fused_gather_segment_sum",
                          dict(rows=gather_rows(emb, n_id), ids=edge.dst,
                               T=n, src=edge.src,
                               count=torch.as_tensor(
                                   edge.count, dtype=torch.int32,
                                   device=dev))))
    return calls


def plain(kernel, kw):
    if kernel == "sorted_segment_sum":
        return S._sorted_segment_sum_plain(kw["rows"], kw["ids"], kw["T"])
    return A._fused_gather_segment_sum_plain(kw["rows"], kw["src"], kw["ids"],
                                             kw["count"], kw["T"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slices", default="32,64,128")
    ap.add_argument("--unrolls", default="8,16")
    ap.add_argument("--min-blocks", default="2,3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_segment_slice: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    pairs = [(int(c), int(u), int(b)) for c in args.slices.split(",")
             for u in args.unrolls.split(",")
             for b in args.min_blocks.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        variants, errors = {}, []

        def run(pair):
            try:
                variants[pair] = build_variant(tmp, *pair)
            except subprocess.CalledProcessError as e:
                errors.append(f"{pair}: {e.stderr}")
        threads = [threading.Thread(target=run, args=(p,)) for p in pairs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError("build failed: " + "; ".join(errors))
        calls = main_path_calls(dev)
        refs = [plain(k, kw) for _, k, kw in calls]
        for C, U, MB in pairs:
            fns = variants[(C, U, MB)]
            times = []
            for (label, k, kw), ref in zip(calls, refs):
                got = call(fns[k], C, **kw)
                torch.testing.assert_close(got, ref, rtol=1e-2, atol=1e-2)
                times.append((label, cs.cuda_ms(
                    lambda: call(fns[k], C, **kw))))
            k1 = sum(ms for label, ms in times if label.startswith("K1"))
            print(f"kSlice={C} kUnroll={U} kMinBlocks={MB} ({fns['ptxas']}): "
                  f"K1 step (4 calls) {k1:.4f} "
                  + " ".join(f"| {label} {ms:.4f}" for label, ms in times),
                  flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
