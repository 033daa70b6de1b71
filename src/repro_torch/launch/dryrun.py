"""The dry run (port of ``repro.launch.dryrun``): every (arch x input shape
x mesh) case of ``launch/steps.py`` built on ``meta`` tensors and counted,
with no device memory and no kernel.

For each case it records one device's share of the argument and output
bytes (from the shapes, dtypes and specs on the production mesh), the
FLOPs (``torch.utils.flop_counter``'s per-op formulas over the case run on
``meta``, :class:`MetaCounter`: the whole program, divided by the chips
for one device's share, and floored by MODEL_FLOPS / chips as the
reference floors XLA's count; ``flops_source`` says which stood), the roofline terms on the H100
(``launch/roofline.py``), and the parameter counts.  Where the reference
reads XLA's memory and cost analyses of the compiled program, the port
has these counts; XLA's temporaries, its HLO collectives and
``DRYRUN_XLA_EXTRA`` have no counterpart (the collective term is None).

The production mesh is built over placeholder devices
(``launch.mesh.placeholder_devices``), so the sweep runs in one process:
no device count is locked at import.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep \\
        --out results/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import roofline, steps
from repro_torch.launch.mesh import make_production_mesh, placeholder_devices
from repro_torch.obs import log as obs_log
from repro_torch.sharding import partition


class MetaCounter(TorchDispatchMode):
    """Counts FLOPs with the per-op formulas of
    ``torch.utils.flop_counter`` (those ``FlopCounterMode`` sums; the
    totals are equal, ``tests/test_torch_launch.py``) and memoises the
    meta outputs of functional ops.

    A meta op's output shapes, strides and dtypes depend only on its
    inputs' metadata and its other arguments, and PyTorch computes many of
    them in Python; a round repeats the same ops for every client and
    layer, so all but the first are looked up.  Ops that mutate or alias
    an input (in-place writes, views) always run."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self._memo: dict = {}

    def _key(self, func, args, kwargs):
        flat, spec = tree_flatten((args, kwargs))
        key = [func, spec]
        for a in flat:
            if isinstance(a, torch.Tensor):
                if a.device.type != "meta":
                    return None
                key.append((tuple(a.shape), a.stride(), a.dtype,
                            a.storage_offset()))
            elif a is None or isinstance(a, _SCALARS):
                key.append((type(a), a))
            else:
                return None
        return tuple(key)

    def _run(self, func, args, kwargs):
        schema = func._schema
        if schema.is_mutable or any(r.alias_info is not None
                                    for r in schema.returns):
            return func(*args, **kwargs)
        key = self._key(func, args, kwargs)
        hit = None if key is None else self._memo.get(key)
        if hit is not None:
            spec, leaves = hit
            return tree_unflatten(
                [torch.empty_strided(v[1], v[2], dtype=v[3], device="meta")
                 if v[0] else v[1] for v in leaves], spec)
        out = func(*args, **kwargs)
        leaves, spec = tree_flatten(out)
        if key is not None and all(isinstance(v, torch.Tensor) or v is None
                                   or isinstance(v, _SCALARS)
                                   for v in leaves):
            self._memo[key] = (spec, [
                (True, tuple(v.shape), v.stride(), v.dtype)
                if isinstance(v, torch.Tensor) else (False, v)
                for v in leaves])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*tree_map(_shape, args),
                                  **tree_map(_shape, kwargs),
                                  out_val=tree_map(_shape, out))
        return out


_SCALARS = (int, float, bool, str, torch.dtype, torch.device, torch.layout,
            torch.memory_format)


def _shape(x):
    return x.shape if isinstance(x, torch.Tensor) else x


def count(case, chips: int, cfg, shape, local_steps: int = 1) -> dict:
    """Run ``case`` on its meta inputs under a :class:`MetaCounter` and
    count one device's bytes (the mesh the case was built on must still be
    active).  Returns the record's measured part."""
    t0 = time.time()
    counter = MetaCounter()
    with counter:
        out = case.fn(*case.args)
    seen: set = set()
    arg_b = sum(steps.tree_bytes(a, s, seen)
                for a, s in zip(case.args, case.specs))
    out_b = steps.tree_bytes(out, case.out_specs(out), seen)
    counted = float(counter.flops)
    n_tokens = (shape.global_batch * shape.seq_len
                if shape.kind != "decode" else shape.global_batch)
    mf = (roofline.model_flops(cfg, n_tokens) * max(local_steps, 1)
          if shape.kind == "train"
          else roofline.model_flops_forward(cfg, n_tokens))
    per_dev = counted / chips
    flops_eff = max(per_dev, mf / chips)
    mem = {"argument_size_in_bytes": arg_b, "output_size_in_bytes": out_b,
           "temp_size_in_bytes": None,
           "total_per_device": arg_b + out_b}
    terms = roofline.roofline_terms(flops_eff, arg_b + out_b, None, chips,
                                    dtype=case.meta["dtype"])
    return dict(
        count_s=round(time.time() - t0, 1), memory=mem,
        cost={"flops": per_dev, "flops_counted": counted,
              "bytes": arg_b + out_b},
        flops_source="counted" if per_dev >= mf / chips else "model_flops",
        collectives=None, collectives_reason=roofline.NO_COLLECTIVES,
        roofline=terms, model_flops=mf,
        useful_flops_ratio=(mf / counted if counted else 0.0),
        n_params=cfg.n_params(), n_active_params=cfg.n_active_params())


def run_one(arch: str, shape_name: str, mesh_kind: str, comm: str = "dense",
            local_steps: int = 1, uplink_ratio: float = 0.1,
            dtype: str = None, seq_shard: bool = False,
            participation: str = "mask", client_chunk: int = 0,
            sampler: str = "uniform", async_buffer: bool = False,
            staleness: str = "constant", obs: bool = False,
            verbose: bool = True) -> dict:
    multi = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi,
                                devices=placeholder_devices(
                                    512 if multi else 256))
    chips = mesh.size
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "chips": chips, "comm": comm, "local_steps": local_steps,
           "uplink_ratio": uplink_ratio, "dtype": dtype or "default",
           "seq_shard": seq_shard, "participation": participation,
           "client_chunk": client_chunk, "sampler": sampler,
           "async_buffer": async_buffer, "staleness": staleness,
           "obs": obs}
    reason = steps.skip_reason(arch, shape_name)
    if reason:
        rec.update(status="skip", reason=reason)
        return rec
    shape = INPUT_SHAPES[shape_name]
    try:
        case = steps.build_case(
            arch, shape_name, mesh, comm=comm, local_steps=local_steps,
            dtype=dtype, seq_shard=seq_shard, uplink_ratio=uplink_ratio,
            participation=participation, client_chunk=client_chunk,
            sampler=sampler, async_buffer=async_buffer, staleness=staleness,
            obs=obs) if shape.kind == "train" else \
            steps.build_case(arch, shape_name, mesh, dtype=dtype)
        cfg = configs.get_config(arch)
        if dtype:
            cfg = dataclasses.replace(cfg, param_dtype=dtype)
        with torch.no_grad() if shape.kind != "train" else \
                torch.enable_grad():
            rec.update(count(case, chips, cfg, shape, local_steps))
    finally:
        partition.activate_mesh(None)
    rec["status"] = "ok"
    rec["dtype"] = case.meta["dtype"]
    if verbose:
        log_record(rec)
    return rec


def log_record(rec: dict) -> None:
    mem, terms = rec["memory"], rec["roofline"]
    obs_log.log(f"== {rec['arch']} x {rec['shape']} x {rec['mesh']} "
                f"({rec['chips']} chips, {rec['dtype']}) ==")
    obs_log.log(f"  memory per device: arguments "
                f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, outputs "
                f"{mem['output_size_in_bytes'] / 1e9:.3f} GB, total "
                f"{mem['total_per_device'] / 1e9:.3f} GB")
    obs_log.log(f"  flops per device: {rec['cost']['flops']:.3e} "
                f"(counted {rec['cost']['flops_counted']:.3e} over "
                f"{rec['chips']} chips; {rec['flops_source']} stood)")
    obs_log.log(f"  roofline (H100): compute={terms['compute_s']:.4f}s "
                f"memory={terms['memory_s']:.4f}s coll=none -> "
                f"{terms['dominant']}-bound")
    obs_log.log(f"  MODEL_FLOPS={rec['model_flops']:.3e} "
                f"useful/counted={rec['useful_flops_ratio']:.3f}")


def sweep(out_path: str, archs=None, shapes=None, meshes=("single", "multi"),
          comm: str = "dense") -> list:
    """Every combination in this process, one JSONL record each (a case
    that raises is an ``error`` record with its reason)."""
    archs = archs or configs.all_arch_names()
    shapes = shapes or list(INPUT_SHAPES)
    recs = []
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mesh in meshes:
                    print(">>", arch, shape, mesh, flush=True)
                    try:
                        rec = run_one(arch, shape, mesh, comm=comm,
                                      verbose=False) \
                            if INPUT_SHAPES[shape].kind == "train" else \
                            run_one(arch, shape, mesh, verbose=False)
                    except Exception as e:  # noqa: BLE001 (a record each)
                        rec = {"arch": arch, "shape": shape, "mesh": mesh,
                               "comm": comm, "status": "error",
                               "error": f"{type(e).__name__}: {e}"[:2000]}
                    recs.append(rec)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--shape", default="train_4k",
                    choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--comm", default="dense",
                    choices=["dense", "packed", "pallas"])
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--uplink-ratio", type=float, default=0.1)
    ap.add_argument("--participation", default="mask",
                    choices=["mask", "gather"],
                    help="engine client-sampling execution")
    ap.add_argument("--client-chunk", type=int, default=0,
                    help="the reference's chunked client vmap (the port "
                         "runs clients one after another)")
    ap.add_argument("--sampler", default="uniform",
                    choices=["uniform", "weighted"],
                    help="client-sampling law (repro_torch.fleet.samplers)")
    ap.add_argument("--async-buffer", action="store_true",
                    help="count the asynchronous buffered round "
                         "(engine.async_rounds): the staleness buffer is "
                         "an extra input")
    ap.add_argument("--staleness", default="constant",
                    choices=["constant", "poly", "constraint"],
                    help="staleness-decay law for the async round")
    ap.add_argument("--obs", action="store_true",
                    help="count the instrumented round (repro_torch.obs)")
    ap.add_argument("--log-level", default="info",
                    help="log threshold for the report "
                         "(repro_torch.obs.log)")
    ap.add_argument("--quiet", action="store_true",
                    help="shorthand for --log-level warning")
    ap.add_argument("--dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--append", default=None, help="append JSONL record here")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--archs", default=None, help="comma list for sweep")
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--meshes", default="single,multi")
    args = ap.parse_args(argv)
    obs_log.set_level("warning" if args.quiet else args.log_level)
    torch.set_num_threads(1)            # meta tensors: nothing to share

    if args.sweep:
        recs = sweep(args.out,
                     archs=args.archs.split(",") if args.archs else None,
                     shapes=args.shapes.split(",") if args.shapes else None,
                     meshes=tuple(args.meshes.split(",")), comm=args.comm)
        by = {}
        for r in recs:
            by[r["status"]] = by.get(r["status"], 0) + 1
        print(f"sweep: {len(recs)} records, {by}", flush=True)
        return 0

    try:
        rec = run_one(args.arch, args.shape, args.mesh, comm=args.comm,
                      local_steps=args.local_steps,
                      uplink_ratio=args.uplink_ratio,
                      dtype=args.dtype, seq_shard=args.seq_shard,
                      participation=args.participation,
                      client_chunk=args.client_chunk, sampler=args.sampler,
                      async_buffer=args.async_buffer,
                      staleness=args.staleness, obs=args.obs)
    except Exception as e:  # noqa: BLE001 (the record says why)
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "comm": args.comm, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
        print(rec["error"])
        print(rec["trace"])
    if args.append:
        os.makedirs(os.path.dirname(args.append) or ".", exist_ok=True)
        with open(args.append, "a") as f:
            slim = dict(rec)
            slim.pop("trace", None)
            f.write(json.dumps(slim) + "\n")
    return 0 if rec.get("status") in ("ok", "skip") else 1


if __name__ == "__main__":
    sys.exit(main())
