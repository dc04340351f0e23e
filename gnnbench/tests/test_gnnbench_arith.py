"""The yardstick's arithmetic against counts made by hand."""

import pytest

from gnnbench import arith
from gnnbench.models import gat, sage

CFG = {"num_layers": 3, "hidden_features": 4, "compute_dtype": "bfloat16",
       "graph": {"num_classes": 2, "num_features": 3}}


def test_k1_bytes_and_ops():
    # 10 real edges of 4 bf16 values (80 B), their ids (40 B), a 6 x 4 f32
    # output (96 B); one add an element
    assert arith.k1_call(10, 6, 4) == (80 + 40 + 96, 40)


def test_k2_bytes_and_ops():
    # 3 distinct rows of 4 bf16 (24 B), 8 B of ids an edge (80 B), 6 x 4
    # f32 out (96 B)
    assert arith.k2_call(3, 10, 6, 4) == (24 + 80 + 96, 40)


def test_k3_bytes():
    # 5 distinct rows read and 7 rows written of 256 B, 7 int32 ids
    assert arith.k3_call(5, 7, 256) == (12 * 256 + 28, 0)


def test_bound_takes_the_slower_side():
    b = arith.HBM_BYTES_PER_S
    o = arith.F32_OPS_PER_S
    assert arith.bound_s([(b, 0), (0, o)]) == pytest.approx(2.0)
    assert arith.bound_s([(b, 2 * o)]) == pytest.approx(2.0)


def test_matmul_flops():
    assert arith.matmul_flops(2, 3, 5) == 60


META = {"level_sizes": [2, 5, 9, 14], "edge_counts": [6, 10, 20],
        "caps": (2, 8, 12, 16), "distinct_outer_src": 7}


def test_sage_kernel_calls():
    calls = sage.kernel_calls(META, "train", CFG)
    # K3: layer 0's 9 real targets written, read with the pad row (the cap
    # is 12), rows of 3 bf16 features (6 B), whatever the program pads to
    assert calls["k3"] == [arith.k3_call(10, 9, 6)]
    assert calls["k3"] == [(19 * 6 + 4 * 9, 0)]
    # K2: layer 0 over hop 2 from the table (3 features), into 9 targets
    assert calls["k2"] == [arith.k2_call(7, 20, 9, 3)]
    assert calls["k2"] == [(7 * 6 + 8 * 20 + 4 * 9 * 3, 60)]
    # K1: hops 0 and 1 forward (real targets) and backward (real
    # sources), width 4
    assert calls["k1"] == [arith.k1_call(6, 2, 4), arith.k1_call(6, 5, 4),
                           arith.k1_call(10, 5, 4), arith.k1_call(10, 9, 4)]
    assert len(sage.kernel_calls(META, "score", CFG)["k1"]) == 2


def test_a_full_cap_reads_no_pad_row():
    full = dict(META, caps=(2, 5, 9, 14))
    assert sage.kernel_calls(full, "train", CFG)["k3"] == [
        arith.k3_call(9, 9, 6)]
    assert gat.kernel_calls(full, "score", CFG)["k3"] == [
        arith.k3_call(14, 14, 6)]


def test_float32_compute_counts_four_bytes():
    f32 = dict(CFG, compute_dtype="float32")
    assert sage.kernel_calls(META, "train", f32)["k3"] == [
        arith.k3_call(10, 9, 12)]
    assert sage.kernel_calls(META, "train", f32)["k1"][0] == \
        arith.k1_call(6, 2, 4, elem_bytes=4)


def test_sage_step_flops_by_hand():
    # layer 0 (hop 2): 9 targets, 3 -> 4: two products 2*9*3*4 each, 20
    # edges of 3 adds; training: forward + weight gradients (x2), no
    # input gradient
    l0 = 2 * (2 * 2 * 9 * 3 * 4) + 20 * 3
    # layer 1 (hop 1): 5 targets, 4 -> 4, 10 edges of 4; x3 and x2
    l1 = 3 * (2 * 2 * 5 * 4 * 4) + 2 * 10 * 4
    # layer 2 (hop 0): 2 targets, 4 -> 2 classes, 6 edges of 4
    l2 = 3 * (2 * 2 * 2 * 4 * 2) + 2 * 6 * 4
    assert sage.step_flops(META, "train", CFG) == l0 + l1 + l2


def test_gat_kernel_calls_and_flops():
    calls = gat.kernel_calls(META, "score", CFG)
    # K3: the 14 real frontier rows written, read with the pad row
    assert calls["k3"] == [arith.k3_call(15, 14, 6)]
    # K1: each layer's real edges into its real targets
    assert calls["k1"] == [arith.k1_call(20, 9, 4), arith.k1_call(10, 5, 4),
                           arith.k1_call(6, 2, 2)]
    # layer 0: projection of 14 rows 3 -> 4, dots 2*14*4 + 2*9*4, edge and
    # self terms 5*(20+9) + 2*(20+9)*4
    l0 = 2 * 14 * 3 * 4 + 2 * 14 * 4 + 2 * 9 * 4 + 5 * 29 + 2 * 29 * 4
    l1 = 2 * 9 * 4 * 4 + 2 * 9 * 4 + 2 * 5 * 4 + 5 * 15 + 2 * 15 * 4
    l2 = 2 * 5 * 4 * 2 + 2 * 5 * 2 + 2 * 2 * 2 + 5 * 8 + 2 * 8 * 2
    assert gat.step_flops(META, "score", CFG) == l0 + l1 + l2
