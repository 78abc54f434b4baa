"""The work counts against hand-worked values."""

import json

import pytest

from perfbench import peaks, spec, work


def cfg(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())


def test_nsf_d64_step_flops():
    # a coupling's conditioner 32 -> 32 -> 32 -> 32 * 29: 31,744 MACs a
    # row; 20 couplings; 2 FLOPs a MAC; 4,096 rows; forward and backward 3x
    macs = 32 * 32 + 32 * 32 + 32 * 928
    assert macs == 31_744
    assert work.train_flops(cfg("nsf_d64"), 4096) == 3 * 2 * 4096 * 20 * macs
    assert work.train_flops(cfg("nsf_d64"), 4096) == pytest.approx(15.603e9,
                                                                   rel=1e-3)
    assert work.forward_flops(cfg("nsf_d64"), 65536) == pytest.approx(
        83.215e9, rel=1e-4)


def test_realnvp_ref_step_flops():
    # s and t nets 1 -> 32 -> 32 -> 1: 1,088 MACs each, 2 a coupling, 20
    macs = 1 * 32 + 32 * 32 + 32 * 1
    assert work.train_flops(cfg("realnvp_ref"), 256) == 3 * 2 * 256 * 40 * macs
    assert work.train_flops(cfg("realnvp_ref"), 256) == pytest.approx(
        66.85e6, rel=1e-3)


def test_rqs_bounds_are_bytes():
    # K1 at 131,072 elements, K = 10: 32 words of 4 bytes an element
    assert work.rqs_bytes("K1", 131072, 10) == 131072 * 32 * 4
    assert work.rqs_bound_s("K1", 131072, 10) == pytest.approx(
        131072 * 128 / peaks.BYTES_PER_S)
    assert work.rqs_bytes("K2", 131072, 10) == 131072 * 62 * 4
    # operations stay well under the bytes' time at K = 10
    assert 131072 * work.rqs_backward_ops(10) / peaks.F32_PER_S < \
        work.rqs_bytes("K2", 131072, 10) / peaks.BYTES_PER_S
    assert work.rqs_elements(cfg("nsf_d64"), 4096) == [131072] * 20


def test_coupling_bounds_as_the_bring_up_read_them():
    # PERF.md's kernel table: the reference default's K4 0.00035 ms and
    # K5 0.00104 ms at 256 rows (bytes), K4 bound by operations at 262,144
    c = cfg("realnvp_ref")
    assert work.coupling_bound_s("K4", c, 256) * 1e3 == pytest.approx(
        0.00035, rel=0.02)
    assert work.coupling_bound_s("K5", c, 256) * 1e3 == pytest.approx(
        0.00104, rel=0.02)
    macs, other = work.coupling_ops("K4", c)
    assert macs == 2 * 2 * 40 // 2 * (32 + 1024 + 32)
    assert work.coupling_bound_s("K4", c, 262144) == pytest.approx(
        262144 * (macs + other) / peaks.F32_PER_S)
