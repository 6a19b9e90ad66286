"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step as one
rank of a pod of 256 or 512 ranks, and extract roofline inputs.

Port of ``repro/launch/dryrun.py``: the same CLI, cell names and JSON
keys (``arch``, ``shape``, ``mesh``, ``kind``, ``params_B``,
``memory``, ``cost``, ``collectives``, ``roofline`` with
``useful_flops_ratio``, ``timing``, ``status``). The reference lowers
and compiles each cell with XLA on 512 placeholder host devices. Here
one process stands in for the whole pod: it joins torch's fake process
group (``init_process_group("fake", store=FakeStore(), ...)`` at the
mesh's size, whose collectives do nothing), builds
``make_production_mesh`` and ``Model.shard(mesh)`` under
``FakeTensorMode`` (no weight is allocated), and traces rank 0's step:
training (AdamW, remat), prefill or decode under the cell's rules
(``sharding.rules_for``, the reference's ``_rules_for``).

What a cell records:
- ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
  step, plus the port's kernels counted by ``roofline.analysis``'s work
  formulas (``_counting_kernels``: for the trace's duration
  ``kernels.ops``' ``attention``, ``decode_attention`` and ``ssd`` are
  replaced by stand-ins that record their work, and their backward's,
  and return an uninitialised result instead of running the plain
  versions' S^2 arithmetic);
- ``cost.bytes_accessed``: a ``TorchDispatchMode`` that adds each op's
  input and output bytes (views and allocations move none), plus the
  kernels' formula bytes. This is an unfused count: every intermediate
  is written and read back, so it runs higher than XLA's fused ``bytes
  accessed``; ``cost.mode`` says so;
- ``collectives``: ``roofline.collective_trace()`` of the port's
  explicit collectives, weighed by the reference's multipliers;
- ``memory.static_arg_bytes_per_device``: the bytes of the rank's
  blocks of the step's arguments (weights, AdamW moments, caches and
  batch), from the shards' shapes. XLA's ``memory_analysis`` alone gives
  the reference's other keys (``argument_size_in_bytes``,
  ``output_size_in_bytes``, ``temp_size_in_bytes``,
  ``alias_size_in_bytes``, ``generated_code_size_in_bytes``); they are
  left out.

Torch counts every layer, since the layers run in a Python loop; XLA
counts a scanned layer once, which the reference's ``--cost-mode
secant`` (``run_cell_secant``, ``_layer_variants``) extrapolates from
two unrolled depths. The option is kept: here both depths are traced
whole, and the extrapolation gives the scan count within 2 % (it is
affine in depth), so it adds nothing but a check.

A cell whose family or layout the port cannot trace records ``status:
"error"`` with the message, and the sweep goes on.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--out DIR]

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json`` at once (cells
already written are skipped unless ``--force``); the default ``--out``
is ``results/dryrun_torch``. ``python -m repro_torch.roofline.report
--dir results/dryrun_torch`` prints the table.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_NAMES, SHAPES, get_config, get_shape,
                                 shape_applicable)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh
from repro_torch.roofline import (analysis, collective_bytes,
                                  collective_trace, model_flops,
                                  roofline_terms)
from repro_torch.sharding import rule_overrides, rules_for
from repro_torch.sharding.partitioning import Sharding


def _device_bytes(tensors) -> int:
    """The bytes of the rank's blocks of ``tensors`` (their local
    shapes)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def param_bytes_per_device(model, mesh, itemsize: int) -> int:
    """Per-rank bytes of the weights' blocks under the active rules at
    ``itemsize`` bytes an element (the reference's: 4 to train, 2 to
    serve), from each ``Sharding``'s block shape."""
    total = 0
    for name, s in model.param_shardings(mesh).items():
        shape = model.get_parameter(name).shape
        total += int(np.prod(Sharding(mesh, s.spec).local_shape(shape),
                             dtype=np.int64)) * itemsize
    return total


def _layer_variants(cfg):
    """Two reduced-depth full-width variants for secant cost accounting
    (the reference's pairs): gemma3 one and two local:global groups,
    Whisper depths 2 and 4, the others 4 and 12."""
    if cfg.local_global_pattern is not None:
        nl, ng = cfg.local_global_pattern
        period = nl + ng
        a, b = period, 2 * period
        return ((a, dataclasses.replace(cfg, num_layers=a)),
                (b, dataclasses.replace(cfg, num_layers=b)), cfg.num_layers)
    if cfg.encoder_layers:
        a, b = 2, 4
        return ((a, dataclasses.replace(cfg, num_layers=a, encoder_layers=a)),
                (b, dataclasses.replace(cfg, num_layers=b, encoder_layers=b)),
                cfg.num_layers)
    a, b = 4, 12
    return ((a, dataclasses.replace(cfg, num_layers=a)),
            (b, dataclasses.replace(cfg, num_layers=b)), cfg.num_layers)


_SKIP = ("empty", "new_empty", "empty_like", "empty_strided", "zeros",
         "zero_", "zeros_like", "scalar_tensor", "lift_fresh", "arange",
         "full", "ones")


# ops that read only the rows they select: their output's bytes twice
_GATHERS = ("index_select", "embedding", "gather")
# ops that write a source into a slice of a larger tensor in place: the
# source's bytes twice
_SCATTERS = ("index_copy_", "index_put_", "scatter_", "slice_scatter")


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Bytes(torch.utils._python_dispatch.TorchDispatchMode):
    """Adds each op's input and output bytes (the module docstring): an
    unfused count; views, allocations and metadata queries move none, a
    gather moves what it selects, a scatter what it writes."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.is_view or name in _SKIP or func.namespace == "prim":
            return out
        if name in _GATHERS:
            self.total += 2 * _tensor_bytes(out)
        elif name in _SCATTERS:
            src = [a for a in args if isinstance(a, torch.Tensor)][-1]
            self.total += 2 * _tensor_bytes(src)
        else:
            self.total += _tensor_bytes((args, kwargs, out))
        return out


class _Counted(torch.autograd.Function):
    """An uninitialised result like ``like`` that adds ``work`` to the
    totals ``into`` (and, in the backward, ``bwd_work``)."""

    @staticmethod
    def forward(ctx, into, name, work, bwd_work, like, *inputs):
        ctx.args = (into, name, bwd_work,
                    [(t.shape, t.dtype) for t in inputs])
        _count(into, name, work)
        return torch.empty_like(like)

    @staticmethod
    def backward(ctx, g):
        into, name, bwd_work, shapes = ctx.args
        _count(into, name + "_bwd", bwd_work)
        return (None,) * 5 + tuple(g.new_empty(s, dtype=d)
                                   for s, d in shapes)


def _count(into: dict, name: str, work: tuple) -> None:
    into["flops"] += work[1]
    into["bytes"] += work[0]
    into["calls"][name] = into["calls"].get(name, 0) + 1


@contextlib.contextmanager
def _counting_kernels():
    """``ops.attention``, ``ops.decode_attention`` and ``ops.ssd`` replaced
    for the block by stand-ins that count their work by
    ``roofline.analysis``'s formulas (the module docstring): yields the
    totals ``{"flops", "bytes", "calls": {name: n}}``."""
    work = {"flops": 0.0, "bytes": 0.0, "calls": {}}

    def attention(q, k, v, causal=True, window=None, scale=None):
        # the backward: dQ, dK and dV's 5 products against the forward's 2
        fwd = analysis.attention_work(q, k, v, window, causal)
        return _Counted.apply(work, "flash_attention", fwd,
                              tuple(2.5 * n for n in fwd), q, q, k, v)

    def decode_attention(q, k, v, length, scale=None, with_lse=False):
        live = length.shape[0] * k.shape[2]          # every slot counted
        _count(work, "decode_attention",
               analysis.decode_work(q, k, v, live))
        out = torch.empty_like(q)
        if not with_lse:
            return out
        return out, q.new_empty(q.shape[:2], dtype=torch.float32)

    def ssd(x, dt, A, Bm, Cm, chunk=128):
        return _Counted.apply(work, "ssd", analysis.ssd_work(x, dt, A, Bm, Cm),
                              analysis.ssd_bwd_work(x, dt, A, Bm, Cm), x, x,
                              dt, A, Bm, Cm)

    saved = (ops.attention, ops.decode_attention, ops.ssd)
    ops.attention, ops.decode_attention, ops.ssd = (attention,
                                                    decode_attention, ssd)
    try:
        yield work
    finally:
        ops.attention, ops.decode_attention, ops.ssd = saved


def _init_fake_group(world: int) -> None:
    """This process as rank 0 of a fake process group of ``world`` ranks
    (a new one where the size changes)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh_for(multi_pod: bool, mesh_shape=None) -> tuple:
    """(mesh name, Mesh) of the cell: the production meshes, or a test
    mesh of ``mesh_shape`` (data, model) or (pod, data, model)."""
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
        name = "pod2x16x16" if multi_pod else "pod16x16"
    else:
        name = "mesh" + "x".join(map(str, mesh_shape))
    axes = ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")
    world = int(np.prod(mesh_shape))
    _init_fake_group(world)
    return name, Mesh(np.arange(world).reshape(mesh_shape), axes)


def _trace_step(model, shape, accum_steps: int):
    """Rank 0's step of ``shape`` on the sharded ``model``: returns
    (the step as a function of nothing, its static arguments, tokens)."""
    from repro_torch.training import adamw, cosine_schedule, make_train_step
    specs, _ = model.input_specs(shape)
    batch = {}
    for k, (shp, dt) in specs.items():
        if shp == ():
            batch[k] = shape.seq_len - 1
            continue
        whole = torch.zeros(shp, dtype=torch.int64 if dt == torch.int32
                            else dt)
        batch[k] = whole
    if shape.kind == "train":
        model.trainable()
        opt = adamw(cosine_schedule(3e-4, 100, 10_000))
        step = make_train_step(model, opt, accum_steps=accum_steps)
        params = dict(model.named_parameters())
        state = opt.init(params)
        local = model.shard_batch(
            {k: v for k, v in batch.items() if k != "targets"})
        local["targets"] = model.shard_batch({"tokens": batch["targets"]})[
            "tokens"]
        args = [*params.values(), *state.m.values(), *state.v.values(),
                *local.values()]
        return (lambda: step(params, state, local)), args, \
            shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        local = model.shard_batch(batch)
        return (lambda: model.prefill(local, max_len=shape.seq_len)), \
            [*model.parameters(), *local.values()], \
            shape.global_batch * shape.seq_len
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    local = model.shard_batch({"token": batch["token"]})
    local["pos"] = shape.seq_len - 1
    args = [*model.parameters(), local["token"],
            *(t for ts in cache.values() for t in ts)]
    return (lambda: model.decode(cache, local)), args, shape.global_batch


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             accum_steps: int = 1, extra_tag: str = "", cfg=None,
             mesh_shape=None, reduced=False):
    """One cell traced as rank 0 (the module docstring). ``mesh_shape``
    and ``reduced`` (the reduced config and shape) make the small cells
    the tests trace."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import build_model
    cfg = cfg or get_config(arch, reduced=reduced)
    shape = get_shape(shape_name, reduced=reduced)
    mesh_name, mesh = _mesh_for(multi_pod, mesh_shape)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "tag": extra_tag,
        "params_B": cfg.param_count() / 1e9,
        "active_params_B": cfg.active_param_count() / 1e9,
    }
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        result.update(status="skipped", reason=why)
        return result
    over = rules_for(cfg, shape, mesh)
    if shape.kind != "train":       # served in bf16, as the reference
        cfg = dataclasses.replace(cfg, dtype="bfloat16")

    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), \
            rule_overrides(**over), mesh:
        model = build_model(cfg, device="cpu")
        model.decode_graphs = False
        model.shard(mesh)
        step, args, tokens = _trace_step(model, shape, accum_steps)
        t_build = time.time() - t0
        t0 = time.time()
        counter = FlopCounterMode(display=False)
        nbytes = _Bytes()
        with _counting_kernels() as work, collective_trace() as trace, \
                counter, nbytes:
            step()
        t_trace = time.time() - t0
        mem = {"static_arg_bytes_per_device": _device_bytes(args),
               "param_bytes_per_device": param_bytes_per_device(
                   model, mesh, 4 if shape.kind == "train" else 2)}
    result["memory"] = mem
    flops = float(counter.get_total_flops() + work["flops"])
    bytes_acc = float(nbytes.total + work["bytes"])
    result["cost"] = {
        "flops": flops, "bytes_accessed": bytes_acc,
        "kernel_flops": float(work["flops"]),
        "kernel_bytes": float(work["bytes"]),
        "kernel_calls": dict(work["calls"]),
        "mode": "traced (every layer; bytes unfused: each op's inputs "
                "and outputs)"}
    coll = collective_bytes(trace)
    counts = coll.pop("_counts")
    coll_total = sum(coll.values())
    result["collectives"] = {"bytes_weighted": coll, "counts": counts,
                             "total_bytes": coll_total}
    terms = roofline_terms(flops, bytes_acc, coll_total)
    mf = model_flops(cfg.param_count(), cfg.active_param_count(),
                     tokens, shape.kind)
    mf_per_dev = mf / mesh.size()
    terms["model_flops_per_device"] = mf_per_dev
    terms["useful_flops_ratio"] = (mf_per_dev / flops) if flops else 0.0
    result["roofline"] = terms
    result["rules"] = {k: list(v) for k, v in over.items()}
    result["timing"] = {"build_s": t_build, "trace_s": t_trace}
    result["status"] = "ok"
    return result


def run_cell_secant(arch: str, shape_name: str, multi_pod: bool,
                    accum_steps: int = 1, extra_tag: str = "", **kw):
    """The cell traced whole, and the reference's secant extrapolation
    from two traced depths (``_layer_variants``) beside it: with every
    layer counted the two agree within 2 % (the module docstring)."""
    real_cfg = get_config(arch, reduced=kw.get("reduced", False))
    base = run_cell(arch, shape_name, multi_pod, accum_steps, extra_tag,
                    **kw)
    if base["status"] != "ok":
        return base
    (a, va), (b, vb), L_real = _layer_variants(real_cfg)
    kw = {k: v for k, v in kw.items() if k != "cfg"}
    ra = run_cell(arch, shape_name, multi_pod, accum_steps, extra_tag,
                  cfg=va, **kw)
    rb = run_cell(arch, shape_name, multi_pod, accum_steps, extra_tag,
                  cfg=vb, **kw)

    def extrap(fa, fb):
        return fa + (fb - fa) / (b - a) * (L_real - a)

    flops = extrap(ra["cost"]["flops"], rb["cost"]["flops"])
    bytes_acc = extrap(ra["cost"]["bytes_accessed"],
                       rb["cost"]["bytes_accessed"])
    base["secant"] = {
        "depths": [a, b], "eq_layers": L_real, "flops": flops,
        "bytes_accessed": bytes_acc,
        "flops_gap": flops / base["cost"]["flops"] - 1.0,
        "bytes_gap": bytes_acc / base["cost"]["bytes_accessed"] - 1.0}
    base["cost_mode"] = "secant"
    return base


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--cost-mode", choices=("scan", "secant"),
                    default="scan")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = []
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    if args.all:
        for a in ARCH_NAMES:
            for s in SHAPES:
                for mp in meshes:
                    cells.append((a, s, mp))
    else:
        assert args.arch and args.shape
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    results = []
    for arch, shape, mp in cells:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        tag = f"__{args.tag}" if args.tag else ""
        path = os.path.join(args.out, f"{arch}__{shape}__{mesh_name}{tag}.json")
        if os.path.exists(path) and not args.force:
            print(f"[skip-existing] {path}")
            continue
        print(f"[cell] {arch} x {shape} x {mesh_name} ...", flush=True)
        t0 = time.time()
        runner = run_cell_secant if args.cost_mode == "secant" else run_cell
        try:
            res = runner(arch, shape, mp, accum_steps=args.accum_steps,
                         extra_tag=args.tag)
        except Exception as e:
            res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()}
        res["wall_s"] = time.time() - t0
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        results.append(res)
        print(f"  -> {res['status']} ({res['wall_s']:.1f}s)", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
