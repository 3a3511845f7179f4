"""Elastic scaling demo of the PyTorch port: checkpoint under one mesh,
restore under another, and continue training (the fleet shrank or grew —
elastic scaling + checkpoint/restart); the twin of
``examples/elastic_rescale.py``.

The parent starts three groups of processes, one after the other: 8, then
4, then 16 ranks of a gloo group, each group on an (n / 2, 2) ("data",
"model") mesh, every rank on the same device (on the card, the ranks share
it; gloo moves the tensors through the host).  A checkpoint holds whole
leaves (``checkpoint.save(..., mesh=)``), and each group restores its own
shards of them (``restore_into(..., mesh=)``):

    PYTHONPATH=src python examples/torch_elastic_rescale.py [--device cpu]

Runs on the card unless ``--device`` names another device, and raises
where there is none.
"""
import argparse
import json
import os
import shutil
import tempfile

import torch
import torch.multiprocessing as mp

STEPS = 10


def child(rank: int, n_dev: int, ckpt: str, phase: str, device: str
          ) -> None:
    """A rank of a group of ``n_dev``: train STEPS steps from the start or
    from the checkpoint, save, and on rank 0 write the phase's record."""
    from repro_torch import checkpoint
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.launch import dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.step import init_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig

    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device).index or 0)
    dist.init("gloo", init_method=f"file://{ckpt}/store_{phase}_{n_dev}",
              rank=rank, world_size=n_dev)
    try:
        mesh = make_mesh((n_dev // 2, 2), ("data", "model"), "cpu")
        cfg = reduced(get_config("qwen3-1.7b"))
        model = build_model(cfg, mesh)
        opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                          global_batch=4)
        step_fn = make_train_step(model, opt)
        state = init_train_state(
            model, torch.Generator(device=device).manual_seed(0), device)
        start = 0
        if phase != "start":
            state, man = checkpoint.restore_into(ckpt, state, mesh=mesh)
            start = man["step"]
        loss = None
        for s in range(start, start + STEPS):
            state, metrics = step_fn(state, batch_at(dcfg, s, device))
            loss = float(metrics["loss"])
        checkpoint.save(ckpt, start + STEPS, state, mesh=mesh)
        if rank == 0:
            with open(os.path.join(ckpt, f"{phase}_{n_dev}.json"), "w") as f:
                json.dump({"devices": n_dev, "mesh": str(dict(mesh.shape)),
                           "from": start, "to": start + STEPS,
                           "loss": loss}, f)
    finally:
        dist.destroy()


def run_child(n_dev, ckpt, phase, device):
    mp.spawn(child, args=(n_dev, ckpt, phase, device), nprocs=n_dev,
             join=True)
    with open(os.path.join(ckpt, f"{phase}_{n_dev}.json")) as f:
        out = json.load(f)
    print(f"  {out['devices']} devices, mesh {out['mesh']}: steps "
          f"{out['from']}→{out['to']}, loss {out['loss']:.4f}")
    return out


def main(argv=None, worlds=(8, 4, 16)):
    """``worlds``: the three groups' sizes (a test passes smaller ones)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, required)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    device = str(resolve_device(args.device))
    a_n, b_n, c_n = worlds
    ckpt = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    try:
        print(f"phase 1: train 10 steps on {a_n} devices "
              f"({a_n // 2}×2 mesh)")
        a = run_child(a_n, ckpt, "start", device)
        print(f"phase 2: fleet shrinks — resume on {b_n} devices "
              f"({b_n // 2}×2 mesh)")
        b = run_child(b_n, ckpt, "resume", device)
        print(f"phase 3: fleet grows — resume on {c_n} devices "
              f"({c_n // 2}×2 mesh)")
        c = run_child(c_n, ckpt, "resume", device)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    assert b["from"] == 10 and c["from"] == 20
    assert c["loss"] < a["loss"], "loss should keep improving across rescales"
    print("elastic rescale OK: checkpoints re-shard across mesh shapes")
    return a, b, c


if __name__ == "__main__":
    main()
