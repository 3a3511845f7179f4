"""Training of the ssm, hybrid and encdec families on a ``(2, 2)``
``("data", "model")`` mesh of four gloo ranks (``tests/torch_mesh_ranks.py``,
kind ``"train"``) against the one-process port, from the reference's init
bridged through numpy: falcon-mamba's channels, recurrentgemma's RG-LRU
channels and gate blocks, attention heads and MLP columns, and whisper's
encoder and decoder heads and MLP columns split over "model", every leaf
FSDP over "data".

Tolerances, float32 compute (the rule of ``tests/test_torch_distributed.py``):
the loss and grad norm at rtol 1e-5 and every parameter, m and v within
1e-4 of the leaf's largest entry, since the ranks sum partial products in
other orders than one process does.  Whisper's key biases, whose exact
gradient is zero, follow ``tests/test_torch_encdec.py``'s rule: their m
and v (rounding noise in both runs) within 1e-4 of the largest entry of
their attention's key weights' m and v, and the biases themselves, which
Adam moves by up to lr a step in either sign, within twice the summed lr.
Two runs on the mesh are ``torch.equal``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
import torch_mesh_ranks as ranks  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)
ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b", "whisper-medium")
STEPS = 3


def _cfgs(arch):
    jcfg = dataclasses.replace(jreduced(jget_config(arch)),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype="float32")
    return jcfg, tcfg


def _as_dict(state) -> dict:
    return {"params": {n: p.detach().clone() for n, p in
                       state.params.named_parameters()},
            "m": {n: t.clone() for n, t in state.opt.m.items()},
            "v": {n: t.clone() for n, t in state.opt.v.items()}}


def _close(name, got, want, frac=1e-4, ref=None):
    got, want = got.detach().float(), want.detach().float()
    scale = float((want if ref is None else ref).abs().max())
    err = float((got - want).abs().max())
    assert err <= frac * scale + 1e-12, (
        f"{name}: {err} > {frac} of its largest entry {scale}")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("families")
    out = {"cfgs": {}, "one": {}}
    init = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        tree = jax.tree.map(np.asarray,
                            jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
        params = bridge.params_from_numpy(tree, tcfg, device="cpu")
        path = str(tmp / f"{tcfg.name}.pt")
        torch.save({"params": {n: p.detach() for n, p in
                               params.named_parameters()}}, path)
        init[tcfg.name] = path
        out["cfgs"][arch] = tcfg
        state = ranks.whole_state(tcfg, torch.load(path))
        state, rec = ranks.run_steps(build_model(tcfg), state, STEPS)
        out["one"][arch] = (rec, _as_dict(state))
    mp.spawn(ranks.main, args=(4, dict(
        kind="train", mesh=(2, 2), cfgs=list(out["cfgs"].values()),
        init=init, steps=STEPS, runs=2, out=str(tmp),
        store=str(tmp / "store"))), nprocs=4, join=True)
    out["mesh"] = torch.load(tmp / "train.pt")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_family_trains_on_a_mesh_as_one_process(work, arch):
    rec1, whole1 = work["one"][arch]
    tcfg = work["cfgs"][arch]
    records, whole = work["mesh"][(tcfg.name, 0)]
    for got, want in zip(records, rec1, strict=True):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
    lr_sum = sum(r["lr"] for r in rec1)
    for kind in ("params", "m", "v"):
        leaves = whole1[kind]
        for n in leaves:
            ref = None
            if n.endswith(".bk"):
                if kind == "params":
                    err = float((whole[kind][n] - leaves[n]).abs().max())
                    assert err <= 2.0 * lr_sum, (n, err, lr_sum)
                    continue
                ref = leaves[n[:-3] + ".wk"]
                _close(f"{arch} {kind} {n} (noise)", leaves[n],
                       torch.zeros_like(leaves[n]), ref=ref)
            _close(f"{arch} {kind} {n}", whole[kind][n], leaves[n], ref=ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_mesh_training_runs_are_equal(work, arch):
    tcfg = work["cfgs"][arch]
    (ra, wa), (rb, wb) = (work["mesh"][(tcfg.name, r)] for r in (0, 1))
    assert ra == rb
    for kind in ("params", "m", "v"):
        for n in wa[kind]:
            assert torch.equal(wa[kind][n], wb[kind][n]), (kind, n)
