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
* ``"moe"``: one MoE block through the mesh path on each rank's part of
  the batch (its data shard; under ``pure_dp`` its (data, model) shard, or
  with ``job["whole"]`` the whole batch, as a batch that does not divide
  over the batch axes is kept); every rank writes its output, aux and drop
  fraction;
* ``"serve"``: for each configuration, the whole parameters loaded from
  ``job["init"]`` and kept as the rank's shards in the serving layout
  (``shard_params``), a prefill of the rank's part of ``job["prompts"]``
  and ``len(job["forced"])`` decode steps fed the forced tokens, twice
  (``job["runs"]``); every rank writes its prefill's caches, each step's
  logits and the final caches.

``job["jobs"]``, where given, is a list of such jobs run one after the
other in the one process group (each on its own mesh, with its own
``out``), so that one spawn serves many checks.  ``job["batch"]`` sets the
global batch of the train steps (``B`` by default).

The encdec family trains on batches with ``enc_embeds`` (``enc_batch``:
seeded normals beside the pipeline's tokens).
"""
from __future__ import annotations

import os

import torch

from repro_torch import checkpoint
from repro_torch.data import DataConfig, batch_at
from repro_torch.launch import dist
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.step import (TrainState, gather_train_state,
                                     make_decode_step, make_prefill_step,
                                     make_train_step, shard_batch,
                                     shard_params, shard_train_state,
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


def enc_batch(cfg, step: int, batch: int = B) -> dict:
    """The pipeline's batch at ``step``, with seeded ``enc_embeds`` for the
    encdec family."""
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                      global_batch=batch)
    out = batch_at(dcfg, step, "cpu")
    if cfg.family == "encdec":
        g = torch.Generator().manual_seed(1000 + step)
        out["enc_embeds"] = torch.randn(
            (batch, cfg.encdec.source_positions, cfg.d_model), generator=g)
    return out


def run_steps(model, state, steps, start=0, batch: int = B):
    fn = make_train_step(model, OPT)
    records = []
    for s in range(start, start + steps):
        state, m = fn(state, enc_batch(model.cfg, s, batch))
        records.append({k: float(v) for k, v in m.items()})
    return state, records


def _whole(state, mesh) -> dict:
    w = gather_train_state(state, mesh, dst=0)
    if w is None:
        return None
    return {"params": w.params, "m": w.opt.m, "v": w.opt.v,
            "step": int(w.opt.step)}


def whole_params(cfg, init: dict):
    """Whole parameters on the CPU from saved leaves, frozen."""
    params = build_model(cfg).init(torch.Generator(), device="meta")
    params = params.to_empty(device="cpu")
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(init["params"][n])
    return params


def serve_run(model, params, prompts: dict, forced: torch.Tensor,
              cache_len: int):
    """A prefill of the rank's part of ``prompts`` and a decode step per
    column of the global ``forced`` tokens: (the prefill's caches, the
    logits of the prefill and of each step, the caches at the end)."""
    mesh = model.mesh
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    batch = prompts if mesh is None else shard_batch(prompts, model.cfg,
                                                     mesh)
    P = next(v for k, v in prompts.items() if k != "enc_embeds").shape[1]
    last, pc = prefill(params, batch)
    saved = _clone(pc)
    B = forced.shape[0]
    caches = model.fill_cache(model.init_cache(B, cache_len, device="cpu"),
                              pc)
    logits = [last]
    for t in range(forced.shape[1]):
        step = {"token": forced[:, t:t + 1], "pos": P + t}
        if mesh is not None:
            step = shard_batch(step, model.cfg, mesh)
        out, caches = decode(params, caches, step)
        logits.append(out)
    return saved, torch.stack(logits, 1), _clone(caches)


def _clone(tree):
    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return type(tree)(_clone(v) for v in tree)


def main(rank: int, world: int, job: dict) -> None:
    torch.set_num_threads(1)
    dist.init("gloo", init_method=f"file://{job['store']}", rank=rank,
              world_size=world)
    try:
        meshes = {}
        for sub in job.get("jobs", [job]):
            shape = tuple(sub["mesh"])
            if shape not in meshes:
                meshes[shape] = make_mesh(shape, ("data", "model"), "cpu")
            _run(rank, meshes[shape], sub)
    finally:
        dist.destroy()


def _run(rank: int, mesh, job: dict) -> None:
    out = {}
    if job["kind"] == "moe":
        cfg = job["cfgs"][0]
        model = build_model(cfg, mesh)
        par = model.sharding
        state = shard_train_state(
            whole_state(cfg, torch.load(job["init"][cfg.name])), mesh)
        lp = par.layer(state.params.layers[0])
        x = job["x"]
        par.whole_batch = bool(job.get("whole"))
        if not par.whole_batch:
            Bl = x.shape[0] // par.data_size
            i = mesh.index(par.batch_axes)
            x = x[i * Bl:(i + 1) * Bl]
        y, aux = apply_moe(lp["moe"], cfg, x, par)
        par.whole_batch = False
        torch.save({"y": y.detach(), **{k: v.detach()
                                         for k, v in aux.items()}},
                   os.path.join(job["out"], f"moe_rank{rank}.pt"))
        return
    if job["kind"] == "serve":
        for cfg in job["cfgs"]:
            model = build_model(cfg, mesh)
            init = torch.load(job["init"][cfg.name])
            for run in range(job.get("runs", 1)):
                params = shard_params(whole_params(cfg, init), mesh)
                with torch.inference_mode():
                    out[(cfg.name, run)] = serve_run(
                        model, params, job["prompts"][cfg.name],
                        job["forced"][cfg.name], job["cache_len"])
        torch.save(out, os.path.join(job["out"], f"serve{rank}.pt"))
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
                                       start, job.get("batch", B))
            if ckpt and job["kind"] == "train" and run == 0:
                checkpoint.save(ckpt, start + job["steps"], state,
                                mesh=mesh)
            whole = _whole(state, mesh)
            out[(cfg.name, run)] = (records, whole)
    if rank == 0:
        torch.save(out, os.path.join(job["out"], "train.pt"))

