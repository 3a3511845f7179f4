"""The ranks of ``tests/test_torch_distributed.py``: each a spawned process
of a gloo group started from a ``file://`` store, on the CPU.  Imports
torch and the port only (no JAX), so the ranks start quickly.

``main(rank, world, job)`` runs ``job["kind"]``:

* ``"train"``: for each configuration, the whole initial train state
  loaded from ``job["init"]`` and sharded on a ``job["mesh"]`` mesh,
  ``job["steps"]`` steps of ``make_train_step`` (twice when ``job["runs"]``
  is 2), then on rank 0 the records and the gathered whole state written
  to ``job["out"]``; where ``job["ckpt"]`` names a directory for the
  configuration, the first run's state is saved there
  (``checkpoint.save(..., mesh=)``) after its steps;
* ``"resume"``: the state restored from ``job["ckpt"]``'s directory into
  a mesh of another shape (``restore_into(..., mesh=)``) and
  ``job["steps"]`` more steps, the records and the whole state written as
  above;
* ``"moe"``: one MoE block through the expert-parallel path on each
  rank's data shard; every rank writes its output, aux and drop fraction.
"""
from __future__ import annotations

import os

import torch

from repro_torch import checkpoint
from repro_torch.data import DataConfig, batch_at
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.step import (TrainState, gather_train_state,
                                     make_train_step, shard_train_state,
                                     trainable)
from repro_torch.models import build_model
from repro_torch.models.moe import apply_moe
from repro_torch.optim import OptConfig, OptState, init_opt

OPT = OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
B, S = 4, 16


def whole_state(cfg, init: dict) -> TrainState:
    """A train state on the CPU from saved whole leaves: ``params`` (by
    name), and ``m``, ``v``, ``step`` where saved."""
    model = build_model(cfg)
    params = trainable(model.init(torch.Generator(), device="meta"))
    params = params.to_empty(device="cpu")
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(init["params"][n])
    opt = init_opt(params)
    if "m" in init:
        opt = OptState(torch.tensor(int(init["step"]), dtype=torch.int32),
                       init["m"], init["v"])
    return TrainState(params, opt)


def run_steps(model, state, steps, start=0):
    fn = make_train_step(model, OPT)
    dcfg = DataConfig(vocab_size=model.cfg.vocab_size, seq_len=S,
                      global_batch=B)
    records = []
    for s in range(start, start + steps):
        state, m = fn(state, batch_at(dcfg, s, "cpu"))
        records.append({k: float(v) for k, v in m.items()})
    return state, records


def _whole(state, mesh) -> dict:
    w = gather_train_state(state, mesh, dst=0)
    if w is None:
        return None
    return {"params": w.params, "m": w.opt.m, "v": w.opt.v,
            "step": int(w.opt.step)}


def main(rank: int, world: int, job: dict) -> None:
    torch.set_num_threads(1)
    dist.init("gloo", init_method=f"file://{job['store']}", rank=rank,
              world_size=world)
    try:
        mesh = make_mesh(job["mesh"], ("data", "model"), "cpu")
        out = {}
        if job["kind"] == "moe":
            cfg = job["cfgs"][0]
            model = build_model(cfg, mesh)
            par = model.sharding
            state = shard_train_state(
                whole_state(cfg, torch.load(job["init"][cfg.name])), mesh)
            lp = par.layer(state.params.layers[0])
            x = job["x"]
            Bl = x.shape[0] // par.data_size
            d = mesh.coords["data"]
            y, aux = apply_moe(lp["moe"], cfg, x[d * Bl:(d + 1) * Bl], par)
            torch.save({"y": y.detach(), **{k: v.detach()
                                             for k, v in aux.items()}},
                       os.path.join(job["out"], f"moe_rank{rank}.pt"))
            return
        for cfg in job["cfgs"]:
            model = build_model(cfg, mesh)
            init = torch.load(job["init"][cfg.name])
            ckpt = job.get("ckpt", {}).get(cfg.name)
            for run in range(job.get("runs", 1)):
                state = shard_train_state(whole_state(cfg, init), mesh)
                start = 0
                if job["kind"] == "resume":
                    state, man = checkpoint.restore_into(ckpt, state,
                                                         mesh=mesh)
                    start = man["step"]
                state, records = run_steps(model, state, job["steps"],
                                           start)
                if ckpt and job["kind"] == "train" and run == 0:
                    checkpoint.save(ckpt, start + job["steps"], state,
                                    mesh=mesh)
                whole = _whole(state, mesh)
                out[(cfg.name, run)] = (records, whole)
        if rank == 0:
            torch.save(out, os.path.join(job["out"], "train.pt"))
    finally:
        dist.destroy()
