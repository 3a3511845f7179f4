"""The dry-run: build every (arch × shape × mesh) cell on the meta device
under a fake process group of 256 (one pod) or 512 (two pods) ranks, and
report each cell's per-device footprint, FLOPs and collectives; port of
``repro/launch/dryrun.py``.

Two passes a cell, each a run of the cell's step (``launch.step.
cell_structs``) on rank 0's shards, every tensor on the meta device, the
collectives those of ``torch.testing._internal.distributed.fake_pg``'s
``"fake"`` backend (they return without moving data):

* census, on both meshes, at full width and full depth: proves that the
  cell's layout is coherent and its step runs on the rank's shards, and
  reports the per-device bytes of the parameters, the optimizer state,
  the caches and the inputs, each from the meta tensors that the resolved
  and sanitized specs shaped.  The step's peak of live bytes is not
  reported: meta tensors hold no storage, so there is no allocator to
  read it from.
* costing, on the single-pod mesh: the step again under
  ``torch.utils.flop_counter.FlopCounterMode`` (the FLOPs of the rank's
  matrix products) and ``launch.mesh.CollectiveCounter`` (the count and
  the bytes of each kind of collective: what the rank-ordered all-gathers
  and all-to-alls move into this rank, not a ring's).  A meta run executes
  every layer, so nothing is extrapolated from reduced depths as the
  reference must.

The roofline takes datasheet figures of an H100 SXM, never measured
times: 989 TFLOP/s of dense bf16, 3.35 TB/s of HBM3, 450 GB/s a direction
of NVLink 4 between the 8 GPUs of a node and 50 GB/s a GPU between nodes
(one 400 Gb/s NIC a GPU).  Ranks fill nodes in order, 8 a node, so on the
(16, 16) mesh a "model" group spans two nodes and a "data" group sixteen;
on (2, 16, 16) the "pod" axis crosses nodes too.  A collective's time is
the larger of its bytes from the rank's own node over NVLink and from
other nodes over the NIC; the step's collective time is their sum.  The
memory time counts each byte of the rank's state (parameters, optimizer
state, caches, inputs) once: a lower bound that leaves activations out.

Usage (on the CPU; no device is touched):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Writes one JSON a cell under ``build/dryrun/<mesh>/`` (``--out``).  A cell
that ``shape_applicable`` rejects is a SKIP; an exception is recorded as a
FAIL, and the command exits non-zero on any FAIL.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCHS, ALL_SHAPES, ShapeConfig, get_config,
                                 shape_applicable)
from repro_torch.launch.mesh import CollectiveCounter, make_mesh

# H100 SXM datasheet figures (not measurements)
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s
HBM_BW = 3.35e12           # B/s, HBM3
NVLINK_BW = 450e9          # B/s a direction, NVLink 4, within a node
NIC_BW = 50e9              # B/s a GPU between nodes (400 Gb/s)
NODE = 8                   # GPUs a node

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = {s.name: s for s in ALL_SHAPES}
OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun"
CROSSES = {"single": "every axis: a 'model' group of 16 spans two nodes of "
                     "8, a 'data' group sixteen",
           "multi": "every axis: 'pod' and 'data' groups span nodes, a "
                    "'model' group two nodes of 8"}


def start(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(kind: str):
    shape, axes = MESHES[kind]
    start(int(torch.tensor(shape).prod()))
    return make_mesh(shape, axes, "cpu")


def model_flops(cfg, shape: ShapeConfig) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (inference)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch       # decode: 1 token/seq


def _nbytes(tree) -> int:
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return sum(_nbytes(p) for p in tree.parameters())
    return 0


def footprint(shape: ShapeConfig, args) -> Dict[str, int]:
    """Per-device bytes of a cell's inputs by role."""
    if shape.kind == "train":
        state, batch = args
        out = {"params": _nbytes(state.params),
               "opt_state": _nbytes([state.opt.step, state.opt.m,
                                     state.opt.v]),
               "caches": 0, "inputs": _nbytes(batch)}
    elif shape.kind == "prefill":
        params, batch = args
        out = {"params": _nbytes(params), "opt_state": 0, "caches": 0,
               "inputs": _nbytes(batch)}
    else:
        params, caches, batch = args
        out = {"params": _nbytes(params), "opt_state": 0,
               "caches": _nbytes(caches), "inputs": _nbytes(batch)}
    out["total"] = sum(out.values())
    return out


def census(cfg, shape: ShapeConfig, mesh):
    """Build the cell and run its step once on rank 0's shards; returns
    the step's inputs."""
    from repro_torch.launch.step import cell_structs
    fn, args, _ = cell_structs(cfg, shape, mesh)
    fn(*args)
    return args


def cost(cfg, shape: ShapeConfig, mesh) -> Dict:
    """FLOPs and collectives of one step on rank 0's shards."""
    from repro_torch.launch.step import cell_structs
    fn, args, _ = cell_structs(cfg, shape, mesh)
    counter = CollectiveCounter(node=NODE)
    flops = FlopCounterMode(display=False)
    with counter, flops:
        fn(*args)
    coll_s = sum(max(e["intra"] / NVLINK_BW, e["inter"] / NIC_BW)
                 for e in counter.events)
    return {"flops": float(flops.get_total_flops()),
            "collective_by_kind": counter.by_kind,
            "collective_bytes": sum(r["bytes"]
                                    for r in counter.by_kind.values()),
            "collective_s": coll_s}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             force: bool = False, cfg_override=None, mesh=None,
             costing: Optional[bool] = None) -> Dict:
    """One cell's record, written to ``out_dir/<arch>__<shape>.json``
    (a cached record is read back unless ``force``).  ``mesh`` defaults to
    the production mesh of ``mesh_kind``; ``costing`` to the single-pod
    mesh."""
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}.json")
    if os.path.exists(out_path) and not force:
        print(f"[skip-cached] {arch} × {shape_name} × {mesh_kind}")
        with open(out_path) as f:
            return json.load(f)
    cfg = cfg_override or get_config(arch)
    force = force or cfg_override is not None
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "kind": shape.kind}
    if not ok:
        rec.update({"status": "SKIP", "reason": reason})
        print(f"[SKIP] {arch} × {shape_name}: {reason}")
    else:
        try:
            mesh = mesh or production_mesh(mesh_kind)
            t0 = time.perf_counter()
            args = census(cfg, shape, mesh)
            t_census = time.perf_counter() - t0
            rec.update({"status": "OK", "chips": mesh.size,
                        "mesh_shape": dict(mesh.shape),
                        "census_s": round(t_census, 2),
                        "bytes_per_device": footprint(shape, args),
                        "peak_live_bytes": None})
            del args
            if costing is None:
                costing = mesh_kind == "single"
            if costing:
                t0 = time.perf_counter()
                c = cost(cfg, shape, mesh)
                mf = model_flops(cfg, shape)
                mem = rec["bytes_per_device"]["total"]
                t_compute = c["flops"] / PEAK_FLOPS
                t_memory = mem / HBM_BW
                terms = {"compute_s": t_compute, "memory_s": t_memory,
                         "collective_s": c["collective_s"]}
                dominant = max(terms, key=terms.get)[:-2]
                rec.update({
                    "costing_s": round(time.perf_counter() - t0, 2),
                    "flops_per_device": c["flops"],
                    "flops_global": c["flops"] * mesh.size,
                    "collective_bytes_per_device": c["collective_bytes"],
                    "collective_by_kind": c["collective_by_kind"],
                    "model_flops": mf,
                    "useful_flop_ratio": mf / max(c["flops"] * mesh.size,
                                                  1.0),
                    "roofline": {**terms, "dominant": dominant,
                                 "bound_step_s": max(terms.values()),
                                 "basis": "H100 SXM datasheet figures, not "
                                          "measured times",
                                 "node_crossing": CROSSES[mesh_kind]}})
                print(f"[OK] {arch} × {shape_name} × {mesh_kind}: "
                      f"dom={dominant} comp={t_compute * 1e3:.2f}ms "
                      f"mem={t_memory * 1e3:.2f}ms "
                      f"coll={c['collective_s'] * 1e3:.2f}ms "
                      f"useful={rec['useful_flop_ratio']:.2f}", flush=True)
            else:
                print(f"[OK] {arch} × {shape_name} × {mesh_kind}: census "
                      f"{t_census:.1f} s", flush=True)
        except Exception as e:  # noqa: BLE001 - recorded, the run goes on
            rec.update({"status": "FAIL", "error": f"{type(e).__name__}: "
                        f"{e}", "traceback": traceback.format_exc()[-4000:]})
            print(f"[FAIL] {arch} × {shape_name} × {mesh_kind}: {e}",
                  flush=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    t0 = time.perf_counter()
    n_fail = 0
    try:
        for mk in meshes:
            for a in archs:
                for s in shapes:
                    rec = run_cell(a, s, mk, os.path.join(args.out, mk),
                                   force=args.force)
                    n_fail += rec.get("status") == "FAIL"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[dryrun] {len(meshes) * len(archs) * len(shapes)} cells in "
          f"{time.perf_counter() - t0:.1f} s, {n_fail} failed", flush=True)
    if n_fail:
        print(f"{n_fail} cells failed")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
