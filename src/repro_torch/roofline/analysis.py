"""Roofline terms of a traced step, and the work of the port's kernels.

Port of ``repro/roofline/analysis.py``. Three terms per (arch, shape,
mesh), all in seconds for one rank's program:

  compute    = FLOPs / peak FLOP/s            (``hw.PEAK_FLOPS_BF16``)
  memory     = bytes / HBM bandwidth          (``hw.HBM_BW``)
  collective = collective bytes / (NVLink per link x links)

The reference reads collectives from compiled HLO text. The port's
collectives are explicit calls of ``sharding/collectives.py``'s raw
``all_reduce``, ``all_gather``, ``reduce_scatter`` and ``all_to_all``;
``collective_trace()`` records each call's op, result shape and dtype,
and ``collective_bytes`` weighs them with the reference's multipliers
(an all-reduce moves ~2x its payload a rank in a ring; the others ~1x).

The kernels' work (``attention_work``, ``decode_work``, ``ssd_work``)
counts what each function must do, whatever implements it: the bytes
of each input read once and each output written once, and the
operations the data needs. ``kernel_bound_s`` is the least time a card
takes for it, ``max(bytes / HBM_BW, ops / PEAK_FLOPS_BF16)``.
``chip_smoke.py`` and ``launch/dryrun.py`` count with these formulas.
"""
from __future__ import annotations

import contextlib
from typing import Dict

from repro_torch.roofline import hw

# op -> traffic multiplier (the reference's table, keyed by its names)
COLLECTIVES = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "ragged-all-to-all": 1.0,
}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


@contextlib.contextmanager
def collective_trace():
    """Record every collective the port makes inside the block: yields
    the list of ``(op, result shape, dtype)`` records. The port's raw
    collectives (``sharding/collectives.py``) are its only callers of
    ``torch.distributed``'s ``all_reduce``, ``all_gather_into_tensor``,
    reduce-scatter and ``all_to_all_single``; for the block each of
    these is wrapped to note its output tensor. An inner trace's calls
    are also the outer's."""
    import torch.distributed as dist
    from repro_torch.sharding.collectives import REDUCE_SCATTER
    ops = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
           REDUCE_SCATTER: "reduce-scatter", "all_to_all_single": "all-to-all"}
    records: list = []
    saved = {name: getattr(dist, name) for name in ops}

    def traced(name):
        def call(out, *args, **kwargs):
            records.append((ops[name], tuple(out.shape), out.dtype))
            return saved[name](out, *args, **kwargs)
        return call

    for name in ops:
        setattr(dist, name, traced(name))
    try:
        yield records
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def collective_bytes(trace) -> Dict[str, float]:
    """Per-type collective traffic [bytes] from ``collective_trace``'s
    records, each result's bytes times its op's multiplier; ``_counts``
    holds the calls of each type."""
    out: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    for op, shape, dtype in trace:
        out[op] += _numel(shape) * hw.BYTES[dtype] * COLLECTIVES[op]
        counts[op] += 1
    out["_counts"] = counts  # type: ignore
    return out


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    coll_bytes: float,
    ici_links: int = hw.NVLINK_LINKS,
) -> Dict[str, float]:
    """All three terms in seconds for the per-rank program; ``ici_links``
    counts the NVLink links the collectives share."""
    compute = flops / hw.PEAK_FLOPS_BF16
    memory = hbm_bytes / hw.HBM_BW
    collective = coll_bytes / (hw.NVLINK_BW_PER_LINK * ici_links)
    dominant = max(
        ("compute", compute), ("memory", memory), ("collective", collective),
        key=lambda kv: kv[1])[0]
    total = max(compute, memory, collective)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "bound_s": total,
    }


def model_flops(param_count: float, active_param_count: float,
                tokens: float, kind: str) -> float:
    """MODEL_FLOPS = 6 N D (train) / 2 N D (inference) with N=active."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * active_param_count * tokens


# ---------------------------------------------------------------------------
# The kernels' work
# ---------------------------------------------------------------------------

def nbytes(*tensors) -> int:
    """The tensors' bytes (each counted once)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def attention_work(q, k, v, window=None, causal: bool = True) -> tuple:
    """(bytes, operations) of prefill attention: q, k and v read once,
    the output (q's size) written once; 4 D operations a (query, key)
    pair that the causal mask and the window keep (every pair, non
    causal)."""
    B, Hq, S, D = q.shape
    Sk = k.shape[2]
    if causal:
        W = window or S
        # sum over t < S of min(t + 1, W), in closed form
        full = min(S, W)
        pairs = full * (full + 1) // 2 + (S - full) * W
    else:
        pairs = S * Sk
    return 2 * nbytes(q) + nbytes(k, v), 4 * B * Hq * D * pairs


def decode_work(q, k, v, length) -> tuple:
    """(bytes, operations) of one decode query against the cache: q and
    the cache read once, the output written once (the lengths are the
    caches' whole; 4 D operations a live slot). ``length`` is a tensor
    or its sum as an int."""
    _, Hq, D = q.shape
    live = length if isinstance(length, int) else int(length.sum())
    lbytes = 0 if isinstance(length, int) else nbytes(length)
    return (2 * nbytes(q) + nbytes(k, v) + lbytes, 4 * Hq * D * live)


def ssd_work(x, dt, A, Bm, Cm, tile: int = 32) -> tuple:
    """(bytes, operations) of the SSD scan: the inputs read once, y (x's
    size) written once; the work, whatever implements it, is the chunked
    algorithm at ``tile``-row tiles, per tile and head the scores
    (2T^2 N), the intra term (2T^2 P), C.h and the state update (2TNP
    each). At 32-row tiles bytes bound it."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    return (nbytes(x, dt, A, Bm, Cm) + nbytes(x),
            B * H * -(-S // tile) * (2 * tile * tile * (N + P)
                                    + 4 * tile * N * P))


def ssd_bwd_work(x, dt, A, Bm, Cm, tile: int = 32) -> tuple:
    """(bytes, operations) of the SSD backward: x, dt, A, Bm, Cm and dy
    (x's size) read once, dx (x's size), ddt, dA, dB and dC (their
    inputs' sizes) written once, no workspace; the work, whatever
    implements it, is the chunked algorithm at ``tile``-row tiles, per
    tile and head the forward's states and the adjoints (2TNP each),
    C.B^T and x.dy^T scaled by the decays (2T^2 N, 2T^2 P), dx (2T^2 P +
    2TNP), dB and dC (2T^2 N + 2TNP each)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    return (2 * nbytes(x, dt, A, Bm, Cm) + nbytes(x),
            B * H * -(-S // tile) * (2 * tile * tile * (3 * N + 2 * P)
                                    + 10 * tile * N * P))


def kernel_bound_s(work: tuple) -> tuple:
    """(seconds, "bytes" or "operations"): the least time the card takes
    for ``work`` and what bounds it."""
    by, ops = work
    mem, comp = by / hw.HBM_BW, ops / hw.PEAK_FLOPS_BF16
    return max(mem, comp), ("bytes" if mem >= comp else "operations")
