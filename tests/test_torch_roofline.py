"""The port's roofline package on hand-computed values, mirroring
``tests/test_roofline.py``'s cases with the H100's roofs: the three
terms, the dominant one, the collective bytes (here from the port's own
collective trace, each record an op, a result shape and a dtype), the
model FLOPs, the dtype table, and the kernels' work formulas that
``chip_smoke.py`` and the dry run share."""
import pytest
import torch
import torch.distributed as dist

from repro_torch import roofline
from repro_torch.roofline import analysis, hw
from repro_torch.sharding import collectives as C


def test_h100_roofs_are_the_data_sheets():
    assert hw.PEAK_FLOPS_BF16 == 989e12
    assert hw.HBM_BW == 3.35e12
    assert hw.NVLINK_LINKS == 18
    assert hw.NVLINK_BW_PER_LINK * hw.NVLINK_LINKS == pytest.approx(900e9)


def test_roofline_terms_hand_computed():
    # exactly one second on each roof, by construction
    t = roofline.roofline_terms(flops=hw.PEAK_FLOPS_BF16,
                                hbm_bytes=hw.HBM_BW,
                                coll_bytes=hw.NVLINK_BW_PER_LINK * 4,
                                ici_links=4)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    assert t["bound_s"] == pytest.approx(1.0)
    # the default counts every NVLink link of the card
    t = roofline.roofline_terms(0.0, 0.0, hw.NVLINK_BW)
    assert t["collective_s"] == pytest.approx(1.0)


def test_roofline_terms_dominant():
    t = roofline.roofline_terms(flops=2 * hw.PEAK_FLOPS_BF16,
                                hbm_bytes=hw.HBM_BW, coll_bytes=0.0)
    assert t["dominant"] == "compute"
    assert t["bound_s"] == pytest.approx(2.0)
    t = roofline.roofline_terms(flops=0.0, hbm_bytes=3 * hw.HBM_BW,
                                coll_bytes=hw.NVLINK_BW_PER_LINK)
    assert t["dominant"] == "memory"
    assert t["bound_s"] == pytest.approx(3.0)
    # halving the links doubles the collective term
    a = roofline.roofline_terms(1.0, 1.0, 1e9, ici_links=4)
    b = roofline.roofline_terms(1.0, 1.0, 1e9, ici_links=2)
    assert b["collective_s"] == pytest.approx(2 * a["collective_s"])


def test_collective_bytes_hand_computed():
    trace = [("all-reduce", (1024, 256), torch.float32),
             ("all-gather", (64, 128), torch.bfloat16),
             ("collective-permute", (16,), torch.float32),
             ("all-to-all", (4, 8), torch.bfloat16)]
    out = roofline.collective_bytes(trace)
    # all-reduce moves ~2x its payload per rank in a ring
    assert out["all-reduce"] == 1024 * 256 * 4 * 2.0
    assert out["all-gather"] == 64 * 128 * 2 * 1.0
    assert out["collective-permute"] == 16 * 4 * 1.0
    assert out["all-to-all"] == 4 * 8 * 2 * 1.0
    assert out["reduce-scatter"] == 0.0
    assert out["_counts"]["all-reduce"] == 1
    assert out["_counts"]["reduce-scatter"] == 0


@pytest.fixture
def fake_mesh():
    """A (2, 2) mesh of torch's fake process group, this process its rank
    0 (the dry run's group: collectives of the right shapes that move
    nothing)."""
    from repro_torch.launch.dryrun import _mesh_for
    try:
        yield _mesh_for(False, (2, 2))[1]
    finally:
        dist.destroy_process_group()


def test_collective_trace_records_and_nests(fake_mesh):
    ax = fake_mesh.axis(("model",))
    x = torch.zeros(4, 3)
    raw = dist.all_reduce
    with roofline.collective_trace() as outer:
        C.all_reduce(x, ax.group)
        with roofline.collective_trace() as inner:
            C.all_gather(x.long(), ax, 0)
        C.reduce_scatter(x, ax, 0)
        C.all_to_all(x.to(torch.bfloat16), ax, 0, 1)
    C.all_reduce(x, ax.group)                   # no trace active: dropped
    assert inner == [("all-gather", (8, 3), torch.int64)]
    assert outer == [("all-reduce", (4, 3), torch.float32), *inner,
                     ("reduce-scatter", (2, 3), torch.float32),
                     ("all-to-all", (4, 3), torch.bfloat16)]
    assert roofline.collective_bytes(inner)["all-gather"] == 8 * 3 * 8.0
    assert dist.all_reduce is raw


def test_model_flops():
    assert roofline.model_flops(1e9, 1e9, 1e12, "train") == 6e21
    # inference counts active params only (MoE)
    assert roofline.model_flops(1e9, 2e8, 1e12, "inference") == \
        2.0 * 2e8 * 1e12


def test_hw_bytes_table():
    assert hw.BYTES[torch.float32] == 4
    assert hw.BYTES[torch.bfloat16] == 2
    assert hw.BYTES[torch.bool] == 1


@pytest.mark.parametrize("window", (None, 3, 64))
def test_attention_work_counts_the_kept_pairs(window):
    B, Hq, Hkv, S, D = 2, 4, 2, 10, 16
    q = torch.zeros(B, Hq, S, D, dtype=torch.bfloat16)
    k = torch.zeros(B, Hkv, S, D, dtype=torch.bfloat16)
    by, ops = analysis.attention_work(q, k, k, window)
    pairs = sum(min(t + 1, window or S) for t in range(S))
    assert ops == 4 * B * Hq * D * pairs
    assert by == 2 * q.numel() * 2 + 2 * k.numel() * 2
    assert analysis.attention_work(q, k, k, causal=False)[1] == \
        4 * B * Hq * D * S * S


def test_decode_and_ssd_work_and_the_bound():
    q = torch.zeros(3, 8, 64)
    k = torch.zeros(3, 2, 100, 64)
    length = torch.tensor([1, 50, 100], dtype=torch.int32)
    by, ops = analysis.decode_work(q, k, k, length)
    assert ops == 4 * 8 * 64 * 151
    assert by == 2 * q.numel() * 4 + 2 * k.numel() * 4 + 3 * 4
    assert analysis.decode_work(q, k, k, 151)[1] == ops
    x = torch.zeros(1, 64, 2, 4)
    dt, A = torch.zeros(1, 64, 2), torch.zeros(2)
    Bm = torch.zeros(1, 64, 8)
    by, ops = analysis.ssd_work(x, dt, A, Bm, Bm)
    assert ops == 1 * 2 * 2 * (2 * 32 * 32 * (8 + 4) + 4 * 32 * 8 * 4)
    s, what = analysis.kernel_bound_s((hw.HBM_BW, 0.0))
    assert (s, what) == (pytest.approx(1.0), "bytes")
    s, what = analysis.kernel_bound_s((0.0, 2 * hw.PEAK_FLOPS_BF16))
    assert (s, what) == (pytest.approx(2.0), "operations")


def test_ssd_bwd_work_counts_the_essential_traffic():
    # mamba2-1.3b's training shape: x, dy, dx in bf16; dt, ddt, B, C, dB,
    # dC (and A, dA) in float32, each read or written once, no workspace;
    # the chunked backward's products at 32-row tiles
    x = torch.zeros(8, 256, 64, 64, dtype=torch.bfloat16)
    dt, A = torch.zeros(8, 256, 64), torch.zeros(64)
    Bm = torch.zeros(8, 256, 128)
    by, ops = analysis.ssd_bwd_work(x, dt, A, Bm, Bm)
    assert by == 3 * x.numel() * 2 + 2 * dt.numel() * 4 + 2 * 64 * 4 \
        + 4 * Bm.numel() * 4 == 55_575_040
    assert ops == 8 * 64 * 8 * (2 * 32 * 32 * (3 * 128 + 2 * 64)
                                + 10 * 32 * 128 * 64)
    assert analysis.kernel_bound_s((by, ops))[1] == "bytes"
