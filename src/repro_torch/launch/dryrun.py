"""Multi-pod dry-run of the port: every (arch x shape x mesh) cell as a
fake-tensor pass of ONE RANK'S PROGRAM on an H100 mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --layout fsdp

The reference lowers and compiles each cell's SPMD step on a forced
512-device host mesh and reads XLA's analyses.  Here `build_cell`
(launch/steps.py) gives the cell's inputs, placed by the reference's rules
(dist/sharding.py), and one rank's program; this process joins a fake
process group of the mesh's size as rank 0 (`make_production_mesh`:
collectives return at once), makes its blocks as fake tensors (the
parameters as DTensors over the mesh) and runs the step under
`FakeTensorMode` on the port's device, `cuda` (`meta` on a PyTorch built
without CUDA, where autograd cannot run on fake CUDA tensors: the kernels'
operators dispatch alike on both).  Nothing is allocated and no kernel is
launched.  `PassCounter`, a dispatch mode beneath the program, reads what
one device does:

  memory       bytes live at the step's start (its arguments: parameters,
               AdamW state, inputs), the peak of live tensors during the
               step, what it leaves (outputs) and the difference (temp);
               fits = peak <= 80 GB (launch/roofline.py)
  cost         flops of the rank's local ops by operand type (the
               formulas of torch.utils.flop_counter, below any DTensor:
               the program runs on the blocks; the flash-decode operator
               counts 4 B Hq S D; a float32 product with TF32 allowed
               counts as "tf32") and the
               bytes its ops read and write (inputs and outputs of every op
               that is not a view: eager PyTorch fuses nothing; a gather
               reads the rows it writes and its indices)
  collectives  c10d calls by type (all-reduce, all-gather, reduce-scatter,
               all-to-all), their bytes and the mesh axes they span
  kernels      calls of each `torch.ops.repro_torch` kernel operator

and `launch/roofline.py` turns them into compute, memory and collective
terms with H100 rates.  The records keep the reference's keys where they
mean the same here (`t_trace_s` stands for its lower and compile times).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.registry import ALL_ARCHS, get_arch
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.launch.steps import build_cell, materialize

_COLLECTIVES = {"allreduce_": "all-reduce", "all_reduce": "all-reduce",
                "allgather_": "all-gather", "_allgather_base_": "all-gather",
                "all_gather_into_tensor": "all-gather",
                "allgather_into_tensor_coalesced_": "all-gather",
                "reduce_scatter_": "reduce-scatter",
                "_reduce_scatter_base_": "reduce-scatter",
                "reduce_scatter_tensor": "reduce-scatter",
                "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
                "all_to_all_single": "all-to-all"}
COLLECTIVE_TYPES = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all")
_GATHERS = {"embedding", "index_select", "gather", "index"}
_TF32_OPS = {"mm", "bmm", "addmm", "baddbmm"}   # cuBLAS: allow_tf32 governs
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "detach", "alias", "_to_copy_meta"}


def _flash_decode_flops(q_shape, k_shape, *args, **kwargs) -> int:
    """q [B, Hq, D] against k, v [B, S, Hkv, D]: q.k and p.v over every
    cache row (the operator's whole cache; its kv_len is data)."""
    B, Hq, D = q_shape
    return 4 * B * Hq * k_shape[1] * D


def _register_flop_formulas():
    from torch.utils.flop_counter import register_flop_formula
    from repro_torch.kernels import ops  # noqa: F401  (defines the ops)
    try:
        register_flop_formula(torch.ops.repro_torch.flash_decode)(
            _flash_decode_flops)
    except RuntimeError:                 # registered already
        pass


_register_flop_formulas()


def pass_device() -> str:
    """The device of the fake pass: `cuda` where PyTorch has CUDA built in
    (the card's machine), else `meta`."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flop_type(name: str, args) -> str:
    """The operand type that sets an op's rate (launch/roofline.py's
    PEAK_FLOPS keys): its first floating-point input's dtype, "tf32" for a
    float32 product while TF32 is allowed."""
    dt = next((t.dtype for t in _tensors(args) if t.is_floating_point()),
              torch.float32)
    if (dt == torch.float32 and name in _TF32_OPS
            and torch.backends.cuda.matmul.allow_tf32):
        return "tf32"
    return str(dt).rpartition(".")[2]


class PassCounter(TorchDispatchMode):
    """Counts what one rank's program does on its device (see the module
    docstring).  `axes_of` maps a process group's name to the mesh axes it
    spans."""

    def __init__(self, axes_of: dict):
        super().__init__()
        self.axes_of = axes_of
        self.live: dict = {}
        self.cur = self.peak = 0
        self.bytes = 0
        self.coll_bytes = dict.fromkeys(COLLECTIVE_TYPES, 0)
        self.coll_ops = dict.fromkeys(COLLECTIVE_TYPES, 0)
        self.coll_axes: dict = {}
        self.kernels: dict = {}
        self.flops: dict = {}       # operand type -> flops
        self.ops = 0

    # -- live device memory --------------------------------------------------

    def track(self, t: torch.Tensor) -> int:
        """Count `t`'s storage as live until it is freed; returns its bytes
        if it was new."""
        if t.device.type not in ("cuda", "meta"):
            return 0
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return 0
        n = st.nbytes()
        self.live[key] = n
        self.cur += n
        self.peak = max(self.peak, self.cur)

        def free(key=key, n=n, live=self.live):
            if live.pop(key, None) is not None:
                self.cur -= n
        weakref.finalize(st, free)
        return n

    # -- collectives -----------------------------------------------------------

    def _group_axes(self, args) -> str:
        for a in tree_flatten(args)[0]:
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = dist.ProcessGroup.unbox(a)
                except Exception:        # a ReduceOp, not a process group
                    continue
                return self.axes_of.get(pg.group_name, "other")
        return "other"

    def _collective(self, name: str, kind: str, args, out):
        ts = _tensors(args)
        if name in ("_allgather_base_", "all_gather_into_tensor"):
            n = _nbytes(ts[0]) if name.startswith("_") else _nbytes(out)
        elif name in ("_reduce_scatter_base_",):
            n = _nbytes(ts[1])
        elif name == "reduce_scatter_tensor":
            n = _nbytes(ts[0])
        elif name in ("allgather_",):
            n = sum(_nbytes(t) for t in ts[:-1]) or _nbytes(ts[0])
        elif name == "alltoall_base_":          # (output, input): the input
            n = _nbytes(ts[1])
        elif name == "alltoall_":               # outputs, then inputs
            n = sum(_nbytes(t) for t in ts) // 2
        else:
            n = sum(_nbytes(t) for t in ts)
        axes = self._group_axes(args)
        self.coll_ops[kind] += 1
        self.coll_bytes[kind] += n
        self.coll_axes[axes] = self.coll_axes.get(axes, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in ("c10d", "_c10d_functional"):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self._collective(name, kind, (args, kwargs), out)
            return out
        if ns == "repro_torch":
            self.kernels[name] = self.kernels.get(name, 0) + 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            kind = _flop_type(name, (args, kwargs))
            self.flops[kind] = (self.flops.get(kind, 0)
                                + formula(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        if outs and ns != "prim" and not func.is_view and name not in _FREE:
            written = sum(_nbytes(t) for t in outs)
            if name in _GATHERS:          # rows read = rows written, + index
                ins = _tensors((args, kwargs))
                read = written + sum(_nbytes(t) for t in ins
                                     if not t.is_floating_point())
            else:
                read = sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += written + read
        return out


def _axes_of(cell) -> dict:
    return {g.group_name: "+".join(axes)
            for axes, g in cell.geo.groups.items()}


def trace_cell(cell, device=None) -> dict:
    """Run one rank's program of `cell` as a fake-tensor pass on `device`
    (default `pass_device()`); returns the counters."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    device = device or pass_device()
    counter = PassCounter(_axes_of(cell))
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params, state, inputs = materialize(cell, device)
        with torch.no_grad():
            blocks = [p.to_local() if hasattr(p, "to_local") else p
                      for p in params.values()]
        arg_p = sum(counter.track(t) for t in blocks)
        arg_o = sum(counter.track(t) for t in _tensors(state or {}))
        arg_i = sum(counter.track(t) for t in _tensors(inputs))
        args_live = counter.cur
        with counter:
            out = cell.step(params, state, inputs)
        out_bytes = sum(_nbytes(t) for t in _tensors(out)
                        if t.untyped_storage()._cdata in counter.live)
        del out
    t_trace = time.perf_counter() - t0
    return {"t_trace_s": t_trace, "flops": float(sum(counter.flops.values())),
            "flops_by_type": dict(counter.flops),
            "counter": counter, "args": args_live, "param_bytes": arg_p,
            "opt_bytes": arg_o, "input_bytes": arg_i, "out_bytes": out_bytes}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, verbose: bool = True,
             layout: str = "2d") -> dict:
    """The record of one cell (see the module docstring); written to
    `out_dir` as <arch>__<shape>__<mesh>[__<layout>].json."""
    mesh = make_production_mesh(multi_pod)
    try:
        cell = build_cell(arch_id, shape_name, mesh, layout=layout)
        tr = trace_cell(cell)
    finally:
        dist.destroy_process_group()
    c = tr["counter"]
    chips = cell.geo.world
    axes_bytes = {tuple(k.split("+")): v for k, v in c.coll_axes.items()
                  if k != "other"}
    terms = rl.roofline_terms(tr["flops_by_type"], float(c.bytes),
                              axes_bytes, chips)
    spec = get_arch(arch_id)
    mflops = rl.model_flops_for(dict(cell.meta, ns_k=20), spec.family,
                                cell.kind)
    peak = c.peak
    record = {
        "arch": arch_id, "shape": shape_name, "kind": cell.kind,
        "layout": layout, "mesh": mesh_name(multi_pod), "chips": chips,
        "device": pass_device(),
        "t_trace_s": round(tr["t_trace_s"], 2),
        "memory": {
            "argument_bytes": tr["args"], "output_bytes": tr["out_bytes"],
            "temp_bytes": peak - tr["args"], "peak_bytes": peak,
            "param_bytes": tr["param_bytes"],
            "optimizer_bytes": tr["opt_bytes"],
            "input_bytes": tr["input_bytes"],
            "fits": peak <= rl.HBM_BYTES},
        "cost": {"flops_per_device": tr["flops"],
                 "flops_by_type": tr["flops_by_type"],
                 "bytes_per_device": float(c.bytes), "ops": c.ops},
        "collectives": {"bytes_by_type": c.coll_bytes,
                        "op_counts": c.coll_ops,
                        "bytes_by_axes": c.coll_axes,
                        "total_bytes_per_device": sum(c.coll_bytes.values())},
        "kernels": c.kernels,
        "roofline": terms,
        "model_flops": mflops,
        "useful_ratio": (mflops / terms["hlo_flops_global"]
                         if terms["hlo_flops_global"] else None),
        "meta": cell.meta,
    }
    serve = getattr(cell.step, "serve", None)
    if serve is not None:
        record["step_collectives"] = serve.collectives
    if verbose:
        m = record["memory"]
        print(f"=== {arch_id} / {shape_name} / {record['mesh']} "
              f"({layout}, trace {tr['t_trace_s']:.1f}s)")
        print(f"  memory: peak {peak / 1e9:.3f} GB (arguments "
              f"{tr['args'] / 1e9:.3f}, temp {m['temp_bytes'] / 1e9:.3f}) "
              f"fits={m['fits']}")
        by_type = ", ".join(f"{k} {v:.3e}"
                            for k, v in tr["flops_by_type"].items())
        print(f"  cost: flops/dev={tr['flops']:.3e} ({by_type}) "
              f"bytes/dev={float(c.bytes):.3e}")
        print(f"  collectives: {c.coll_ops} bytes {c.coll_axes}")
        print(f"  kernels: {c.kernels}")
        print(f"  roofline: compute={terms['t_compute_s']:.3e}s "
              f"memory={terms['t_memory_s']:.3e}s "
              f"collective={terms['t_collective_s']:.3e}s "
              f"-> dominant={terms['dominant']}")
        ratio = record["useful_ratio"]
        print(f"  MODEL_FLOPS={mflops:.3e} useful_ratio={ratio:.3f}"
              if ratio is not None else "  MODEL_FLOPS n/a", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch_id}__{shape_name}__{record['mesh'].replace('x', '_')}"
        if layout != "2d":
            tag += f"__{layout}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(record, f, indent=1)
    return record


def summary_table(out_dir: str) -> str:
    """A markdown table of the records in `out_dir`, one row per (arch,
    shape, layout) and a column per mesh: peak GB per device (NO where it
    does not fit), the dominant term and its seconds, the useful ratio."""
    cells, meshes = {}, []
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(out_dir, name)) as fh:
            r = json.load(fh)
        t, m = r["roofline"], r["memory"]
        ratio = r["useful_ratio"]
        key = (r["arch"], r["shape"], r["layout"])
        if r["mesh"] not in meshes:
            meshes.append(r["mesh"])
        cells.setdefault(key, {})[r["mesh"]] = (
            f"{m['peak_bytes'] / 1e9:.2f}{'' if m['fits'] else ' NO'}, "
            f"{t['dominant'][:4]} {t['t_dominant_s']:.3g}, "
            f"{'n/a' if ratio is None else f'{ratio:.2f}'}")
    meshes.sort(key=len)
    head = ("| arch | shape | layout | " + " | ".join(meshes) + " |\n"
            + "| --- " * (3 + len(meshes)) + "|")
    rows = [f"| {a} | {s} | {lay} | "
            + " | ".join(v.get(mesh, "—") for mesh in meshes) + " |"
            for (a, s, lay), v in cells.items()]
    return "\n".join([head] + rows)


def _run_one(job, out, layout, stop_on_error=False) -> list:
    """Run one (arch, shape, multi_pod) cell; [] or its failure."""
    arch, shape, mp = job
    try:
        run_cell(arch, shape, mp, out_dir=out, layout=layout)
    except Exception as e:
        print(f"!!! FAILED {arch}/{shape}/mp={mp}: {e}", flush=True)
        traceback.print_exc()
        if stop_on_error:
            raise
        return [(arch, shape, mp, repr(e))]
    return []


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--layout", default="2d", choices=["2d", "fsdp"],
                    help="LM train sharding: 2d = TP x DP with the sequence "
                         "split on 'model'; fsdp = pure ZeRO-3")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch/shape pairs, in place of "
                         "--arch and --shape")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (its own fake process group)")
    ap.add_argument("--table", action="store_true",
                    help="print a markdown table of the records in --out "
                         "(per mesh: peak GB, dominant term and seconds, "
                         "useful ratio) and trace nothing")
    ap.add_argument("--stop-on-error", action="store_true")
    args = ap.parse_args(argv)
    if args.table:
        print(summary_table(args.out))
        return

    if args.cells:
        cells = [tuple(c.split("/")) for c in args.cells.split(",")]
    else:
        archs = ALL_ARCHS if args.arch == "all" else [args.arch]
        cells = [(a, s) for a in archs
                 for s in (get_arch(a).shapes if args.shape == "all"
                           else [args.shape])]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    t0 = time.perf_counter()
    jobs = [(arch, shape, mp) for arch, shape in cells for mp in meshes]
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.jobs, mp_context=ctx,
                                 max_tasks_per_child=1) as pool:
            futs = [pool.submit(_run_one, j, args.out, args.layout)
                    for j in jobs]
            for fut in futs:
                failures += fut.result()
    else:
        for job in jobs:
            failures += _run_one(job, args.out, args.layout,
                                 args.stop_on_error)
    print(f"\nwall {time.perf_counter() - t0:.1f}s")
    print(f"done; {len(failures)} failures")
    for f in failures:
        print("  FAILED:", f)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
