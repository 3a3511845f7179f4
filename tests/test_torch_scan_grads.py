"""The backward passes of the two scans (RG-LRU, Mamba): their plain twins,
their ``torch.autograd.Function`` wiring and the models' training paths
through it.

* On the CPU: ``ref.rglru_scan_bwd`` and ``ref.mamba_scan_bwd`` (explicit
  reverse loops) against ``jax.vjp`` of the JAX package's plain scans
  (``repro.kernels.ref.rglru_scan`` / ``mamba_scan``) and against torch
  autograd of the port's plain scans, in float32 within 1e-5 of each
  gradient's largest entry (the libraries sum dC, and JAX its carries, in
  other orders); with a cotangent of the Mamba scan's last state too.
  The Mamba twins' state checkpoints (every ``ref.CHECKPOINT_EVERY``
  steps, S below, at, one past and not a multiple of it) equal the plain
  scan's states and the states of ``jax.lax.scan`` over the reference's
  recurrence, and the backward twin started from them returns the bits it
  returns without them.  ``ops.RGLRUScan`` and ``ops.MambaScan`` run on
  the CPU with the plain versions injected and give the twins' gradients
  exactly, the checkpointing forward handing its states to the backward;
  the kernel route takes the checkpointing forward only under autograd.
  The reduced
  falcon-mamba-7b and recurrentgemma-9b, in float32, take their loss's
  gradient through that wiring (every op of ``ops`` routed to its plain
  twin as the kernel path would route it to a kernel) within 1e-5 of each
  leaf's largest entry of the plain path's autograd.
* On the card (marker ``cuda``, skipped without one): each kernel equal to
  its twin bit for bit (da, db and dC) at small, ragged and full-width
  shapes, two launches equal, the Mamba backward from the forward kernel's
  checkpoints and standalone; the checkpointing forward's y and h_last
  equal to the contract entry point's, its checkpoints to the twin's;
  ``ops.rglru_scan`` and ``ops.mamba_scan_with_state`` under autograd
  launch the backward kernels.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as cuda_flash  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as cuda_fb  # noqa: E402
from repro_torch.kernels import mamba_scan as cuda_mamba  # noqa: E402
from repro_torch.kernels import mamba_scan_bwd as cuda_mb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as cuda_rglru  # noqa: E402
from repro_torch.kernels import rglru_scan_bwd as cuda_rb  # noqa: E402
from repro_torch.kernels import rmsnorm as cuda_rmsnorm  # noqa: E402
from repro_torch.kernels import rmsnorm_bwd as cuda_nb  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

torch.set_num_threads(1)
FRAC = 1e-5
RGLRU = [(2, 37, 24), (1, 64, 130), (3, 5, 7)]          # B, S, W
MAMBA = [(2, 37, 40, 4), (1, 29, 64, 16), (2, 9, 33, 8)]  # B, S, D, N


def _inputs(shape, seed):
    """a ~ U[0.5, 0.999], b and the cotangents ~ N(0, 1), float32 numpy."""
    g = np.random.default_rng(seed)
    a = g.uniform(0.5, 0.999, shape).astype(np.float32)
    return a, g.standard_normal(shape).astype(np.float32), g


def _near(got, want, what, frac=FRAC):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= frac * scale, f"{what}: {err:.3g} over {frac} x {scale:.3g}"


@pytest.mark.parametrize("shape", RGLRU)
def test_rglru_twin_matches_jax_vjp_and_autograd(shape):
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    jref = pytest.importorskip("repro.kernels.ref")
    a, b, g = _inputs(shape, 0)
    dy = g.standard_normal(shape).astype(np.float32)
    at, bt, dyt = (torch.from_numpy(x) for x in (a, b, dy))
    h = ref.rglru_scan(at, bt)
    da, db = ref.rglru_scan_bwd(at, h, dyt)
    al, bl = at.clone().requires_grad_(), bt.clone().requires_grad_()
    auto = torch.autograd.grad(ref.rglru_scan(al, bl), (al, bl), dyt)
    _, vjp = jax.vjp(jref.rglru_scan, jnp.asarray(a), jnp.asarray(b))
    jg = vjp(jnp.asarray(dy))
    for name, mine, x, j in zip(("da", "db"), (da, db), auto, jg):
        _near(mine.numpy(), x.numpy(), f"{name} against autograd")
        _near(mine.numpy(), np.asarray(j), f"{name} against jax.vjp")


@pytest.mark.parametrize("with_last", [False, True])
@pytest.mark.parametrize("shape", MAMBA)
def test_mamba_twin_matches_jax_vjp_and_autograd(shape, with_last):
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    jref = pytest.importorskip("repro.kernels.ref")
    B, S, D, N = shape
    a, b, g = _inputs(shape, 1)
    b = (b * 0.1).astype(np.float32)
    C = g.standard_normal((B, S, N)).astype(np.float32)
    dy = g.standard_normal((B, S, D)).astype(np.float32)
    dl = g.standard_normal((B, D, N)).astype(np.float32)
    at, bt, Ct, dyt, dlt = (torch.from_numpy(x) for x in (a, b, C, dy, dl))
    mine = ref.mamba_scan_bwd(at, bt, Ct, dyt, dlt if with_last else None)
    leaves = [x.clone().requires_grad_() for x in (at, bt, Ct)]
    y, h_last = ref.mamba_scan_with_state(*leaves)
    outs, cots = ([y, h_last], [dyt, dlt]) if with_last else ([y], [dyt])
    auto = torch.autograd.grad(outs, leaves, cots)
    for name, m, x in zip(("da", "db", "dC"), mine, auto):
        _near(m.numpy(), x.numpy(), f"{name} against autograd")
    if with_last:
        return     # the JAX oracle returns y only
    _, vjp = jax.vjp(jref.mamba_scan, *(jnp.asarray(x) for x in (a, b, C)))
    for name, m, j in zip(("da", "db", "dC"), mine, vjp(jnp.asarray(dy))):
        _near(m.numpy(), np.asarray(j), f"{name} against jax.vjp")


def test_mamba_twin_dc_groups_are_the_kernels():
    """dC sums its channels in runs of 32 by a halving tree, then the runs
    in order: a sum over D = 33 equals that grouping written out."""
    B, S, D, N = 1, 3, 33, 4
    a, b, g = _inputs((B, S, D, N), 2)
    C = torch.from_numpy(g.standard_normal((B, S, N)).astype(np.float32))
    dy = torch.from_numpy(g.standard_normal((B, S, D)).astype(np.float32))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    *_, dC = ref.mamba_scan_bwd(at, bt, C, dy)
    h = torch.zeros(B, D, N)
    hs = []
    for t in range(S):
        h = at[:, t] * h + bt[:, t]
        hs.append(h)
    q = dy[..., None] * torch.stack(hs, 1)                 # [B,S,D,N]
    x = q[:, :, :32]
    for half in (16, 8, 4, 2, 1):
        x = x[:, :, :half] + x[:, :, half:2 * half]
    assert torch.equal(dC, x[:, :, 0] + q[:, :, 32])


def test_scan_functions_wiring_on_the_cpu():
    """``RGLRUScan`` and ``MambaScan`` with the plain versions injected:
    the forward is the plain forward, the gradients are the twins'
    exactly, and a last-state cotangent that no loss reaches comes as
    ``None``."""
    a, b, g = _inputs((2, 19, 24), 3)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    dh = torch.from_numpy(g.standard_normal(a.shape).astype(np.float32))
    al, bl = at.clone().requires_grad_(), bt.clone().requires_grad_()
    h = ops.RGLRUScan.apply(al, bl, ref.rglru_scan, ref.rglru_scan_bwd)
    assert torch.equal(h, ref.rglru_scan(at, bt))
    got = torch.autograd.grad(h, (al, bl), dh)
    want = ref.rglru_scan_bwd(at, h.detach(), dh)
    assert all(torch.equal(x, y) for x, y in zip(got, want))

    a, b, g = _inputs((2, 13, 40, 8), 4)
    C = torch.from_numpy(g.standard_normal((2, 13, 8)).astype(np.float32))
    dy = torch.from_numpy(g.standard_normal((2, 13, 40)).astype(np.float32))
    seen = []

    def bwd(*args):
        seen.append(args[4])
        return ref.mamba_scan_bwd(*args)

    leaves = [torch.from_numpy(x).clone().requires_grad_()
              for x in (a, b)] + [C.clone().requires_grad_()]
    y, h_last = ops.MambaScan.apply(*leaves, ref.mamba_scan_with_checkpoints,
                                    bwd)
    want_y, want_h = ref.mamba_scan_with_state(*(x.detach() for x in leaves))
    assert torch.equal(y, want_y) and torch.equal(h_last, want_h)
    got = torch.autograd.grad(y, leaves, dy)
    assert seen == [None]
    want = ref.mamba_scan_bwd(*(x.detach() for x in leaves), dy)
    assert all(torch.equal(x, w) for x, w in zip(got, want))


T = ref.CHECKPOINT_EVERY
# B, S, D, N: S below, at, one past and not a multiple of the checkpoint
# interval, at the smallest and the training state size
CHK = [(2, S, D, N) for S in (T - 7, T, T + 1, 3 * T + 5)
       for D, N in ((24, 4), (9, 16))]


def _mamba_inputs(shape, seed):
    """a, b (x 0.1), C, dy and dh_last of a Mamba scan, float32 numpy."""
    B, S, D, N = shape
    a, b, g = _inputs(shape, seed)
    C = g.standard_normal((B, S, N)).astype(np.float32)
    dy = g.standard_normal((B, S, D)).astype(np.float32)
    dl = g.standard_normal((B, D, N)).astype(np.float32)
    return a, (b * 0.1).astype(np.float32), C, dy, dl


@pytest.mark.parametrize("shape", CHK)
def test_mamba_checkpoint_twin_matches_the_scan_states(shape):
    """The twins' checkpoints are the plain scan's states h_{cT-1} bit for
    bit (the port's loop cut at each checkpoint), and the states of the
    reference's recurrence under ``jax.lax.scan`` (whose y is the JAX
    package's ``mamba_scan``) within 1e-5 of their largest entry; the
    checkpointing forward's y and h_last are ``mamba_scan_with_state``'s."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    jref = pytest.importorskip("repro.kernels.ref")
    B, S, D, N = shape
    a, b, C, _, _ = _mamba_inputs(shape, 8)
    at, bt, Ct = (torch.from_numpy(x) for x in (a, b, C))
    chk = ref.mamba_scan_checkpoints(at, bt)
    assert chk.shape == (B, (S - 1) // T, D, N)
    y, h_last, chk2 = ref.mamba_scan_with_checkpoints(at, bt, Ct)
    want_y, want_h = ref.mamba_scan_with_state(at, bt, Ct)
    assert torch.equal(y, want_y) and torch.equal(h_last, want_h)
    assert torch.equal(chk2, chk)
    for c in range(1, chk.shape[1] + 1):
        _, h = ref.mamba_scan_with_state(at[:, :c * T], bt[:, :c * T],
                                         Ct[:, :c * T])
        assert torch.equal(chk[:, c - 1], h), c

    def step(h, xs):                  # jref.mamba_scan's step, h kept
        a_t, b_t, c_t = xs
        h = a_t * h + b_t
        return h, (h, jnp.einsum("bdn,bn->bd", h, c_t))

    _, (hs, ys) = jax.lax.scan(
        step, jnp.zeros((B, D, N), jnp.float32),
        tuple(jnp.moveaxis(jnp.asarray(x), 1, 0) for x in (a, b, C)))
    np.testing.assert_array_equal(
        np.moveaxis(np.asarray(ys), 0, 1),
        np.asarray(jref.mamba_scan(*(jnp.asarray(x) for x in (a, b, C)))))
    hs = np.moveaxis(np.asarray(hs), 0, 1)               # [B, S, D, N]
    if chk.shape[1]:
        _near(chk.numpy(), hs[:, T - 1:(S - 1) // T * T:T],
              "checkpoints against jax.lax.scan's states")


@pytest.mark.parametrize("with_last", [False, True])
@pytest.mark.parametrize("shape", CHK)
def test_mamba_twin_with_checkpoints_equals_without(shape, with_last):
    """``ref.mamba_scan_bwd`` started from the twin's checkpoints returns
    the bits it returns recomputing h from zero."""
    a, b, C, dy, dl = (torch.from_numpy(x)
                       for x in _mamba_inputs(shape, 9))
    dl = dl if with_last else None
    chk = ref.mamba_scan_checkpoints(a, b)
    want = ref.mamba_scan_bwd(a, b, C, dy, dl)
    got = ref.mamba_scan_bwd(a, b, C, dy, dl, chk)
    assert all(torch.equal(x, w) for x, w in zip(got, want))


@pytest.mark.parametrize("with_last", [False, True])
@pytest.mark.parametrize("shape", [(2, 3 * T + 5, 24, 4),
                                   (1, 2 * T + 1, 9, 16)])
def test_mamba_function_with_checkpoints_matches_autograd_and_jax_vjp(
        shape, with_last):
    """``ops.MambaScan`` wired with the plain twins, the checkpointing
    forward handing its states to the backward: the gradients against
    autograd of the plain forward and (y's cotangent alone, as the JAX
    oracle returns y only) ``jax.vjp`` of the JAX package's scan, within
    1e-5 of each gradient's largest entry."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    jref = pytest.importorskip("repro.kernels.ref")
    a, b, C, dy, dl = _mamba_inputs(shape, 10)
    dyt, dlt = torch.from_numpy(dy), torch.from_numpy(dl)
    seen = []

    def bwd(*args):
        seen.append(args[5])
        return ref.mamba_scan_bwd(*args)

    leaves = [torch.from_numpy(x).clone().requires_grad_() for x in (a, b, C)]
    y, h_last = ops.MambaScan.apply(*leaves, ref.mamba_scan_with_checkpoints,
                                    bwd)
    outs, cots = ([y, h_last], [dyt, dlt]) if with_last else ([y], [dyt])
    got = torch.autograd.grad(outs, leaves, cots)
    chk = ref.mamba_scan_checkpoints(*(x.detach() for x in leaves[:2]))
    assert len(seen) == 1 and torch.equal(seen[0], chk)
    plain = [x.detach().clone().requires_grad_() for x in leaves]
    outs = ref.mamba_scan_with_state(*plain)
    auto = torch.autograd.grad(outs if with_last else outs[:1], plain, cots)
    for name, m, x in zip(("da", "db", "dC"), got, auto):
        _near(m.numpy(), x.numpy(), f"{name} against autograd")
    if with_last:
        return
    _, vjp = jax.vjp(jref.mamba_scan, *(jnp.asarray(x) for x in (a, b, C)))
    for name, m, j in zip(("da", "db", "dC"), got, vjp(jnp.asarray(dy))):
        _near(m.numpy(), np.asarray(j), f"{name} against jax.vjp")


def test_mamba_checkpoints_only_where_autograd_records(monkeypatch):
    """On the kernel route ``ops.mamba_scan_with_state`` takes the
    checkpointing forward only where autograd records the scan; serving
    (no grad, or no input needing one) takes the Pallas-contract entry."""
    calls = _kernel_wiring(monkeypatch)
    a, b, C, dy, _ = (torch.from_numpy(x)
                      for x in _mamba_inputs((1, T + 3, 8, 4), 11))
    want = ref.mamba_scan_with_state(a, b, C)
    got = ops.mamba_scan_with_state(a, b, C)
    with torch.no_grad():
        got_ng = ops.mamba_scan_with_state(a, b, C.requires_grad_())
    assert calls == {"mamba_scan_with_state": 2}
    al = a.clone().requires_grad_()
    y, h_last = ops.mamba_scan_with_state(al, b, C.detach())
    assert calls["mamba_scan_with_checkpoints"] == 1
    for x, w in ((got, want), (got_ng, want), ((y, h_last), want)):
        assert all(torch.equal(p.detach(), q) for p, q in zip(x, w))
    torch.autograd.grad(y, al, dy)
    assert calls["mamba_scan_bwd"] == 1


def test_cpu_tensors_take_plain_autograd():
    """On the CPU ``ops.rglru_scan`` and ``ops.mamba_scan_with_state`` are
    the plain versions (autograd differentiates them); the backward
    kernels' wrappers refuse CPU tensors."""
    a = torch.rand(2, 5, 8).requires_grad_()
    h = ops.rglru_scan(a, torch.rand(2, 5, 8))
    assert not isinstance(h.grad_fn, ops.RGLRUScan._backward_cls)
    a4 = torch.rand(2, 5, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rb.rglru_scan_bwd(a, a.detach(), a.detach())
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mb.mamba_scan_bwd(a4, a4, torch.rand(2, 5, 4),
                               torch.rand(2, 5, 8))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mamba.mamba_scan_with_checkpoints(a4, a4, torch.rand(2, 5, 4))


def _kernel_wiring(monkeypatch):
    """Every op of ``ops`` takes its kernel route (the autograd Functions)
    on the CPU, each kernel replaced by its plain twin; returns the calls
    of each by name."""
    calls = {}

    def counted(name, twin):
        def run(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return twin(*args, **kwargs)
        return run

    monkeypatch.setattr(ops, "_plain", lambda t: False)
    for mod, name, twin in (
            (cuda_flash, "flash_attention", ref.flash_attention),
            (cuda_fb, "flash_attention_bwd", ref.flash_attention_bwd),
            (cuda_rmsnorm, "rmsnorm", ref.rmsnorm),
            (cuda_nb, "rmsnorm_bwd", ref.rmsnorm_bwd),
            (cuda_rglru, "rglru_scan", ref.rglru_scan),
            (cuda_rb, "rglru_scan_bwd", ref.rglru_scan_bwd),
            (cuda_mamba, "mamba_scan_with_state", ref.mamba_scan_with_state),
            (cuda_mamba, "mamba_scan_with_checkpoints",
             ref.mamba_scan_with_checkpoints),
            (cuda_mb, "mamba_scan_bwd", ref.mamba_scan_bwd)):
        monkeypatch.setattr(mod, name, counted(name, twin))
    return calls


def _loss_and_grads(model, params, batch):
    names, leaves = zip(*params.named_parameters())
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for n, p, g in zip(names, leaves, grads)}


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_model_gradients_through_the_scan_functions(arch, monkeypatch):
    """The reduced model's float32 loss gradient through the kernel route's
    wiring (the scans' autograd Functions and the call sites around them:
    ``C.contiguous()``, ``h[:, -1].clone()``) equals the plain path's
    autograd within 1e-5 of each leaf's largest entry."""
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    params.requires_grad_(True)
    g = np.random.default_rng(5)
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (2, 24)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    loss_p, want = _loss_and_grads(model, params, batch)
    with monkeypatch.context() as m:
        calls = _kernel_wiring(m)
        loss_k, got = _loss_and_grads(model, params, batch)
    scan = "mamba_scan" if cfg.family == "ssm" else "rglru_scan"
    pat = cfg.hybrid.pattern if cfg.hybrid else ("ssm",)
    n_scans = sum(pat[i % len(pat)] != "attn" for i in range(cfg.num_layers))
    # remat "nothing": each forward runs twice, each backward once
    assert calls.get(f"{scan}_bwd") == n_scans, calls
    assert calls.get("rmsnorm_bwd", 0) > 0, calls
    assert abs(float(loss_k) - float(loss_p)) <= 1e-6 * abs(float(loss_p))
    for n, w in want.items():
        _near(got[n].numpy(), w.numpy(), f"{arch} gradient {n}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RGLRU + [(4, 512, 4096), (2, 100, 4099)])
def test_rglru_bwd_kernel_equals_twin_on_card(cuda, shape):
    a, b, g = _inputs(shape, 6)
    at, bt = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    dy = torch.from_numpy(g.standard_normal(shape).astype(np.float32)
                          ).to(cuda)
    h = ref.rglru_scan(at, bt)
    got = cuda_rb.rglru_scan_bwd(at, h, dy)
    again = cuda_rb.rglru_scan_bwd(at, h, dy)
    want = ref.rglru_scan_bwd(at, h, dy)
    assert all(torch.equal(x, w) and torch.equal(x, y)
               for x, y, w in zip(got, again, want))


@pytest.mark.cuda
@pytest.mark.parametrize("with_last", [False, True])
@pytest.mark.parametrize("shape", MAMBA + [(4, 512, 8192, 16),
                                           (1, 77, 100, 12)])
def test_mamba_bwd_kernel_equals_twin_on_card(cuda, shape, with_last):
    B, S, D, N = shape
    a, b, g = _inputs(shape, 7)
    at = torch.from_numpy(a).to(cuda)
    bt = torch.from_numpy((b * 0.1).astype(np.float32)).to(cuda)
    C = torch.from_numpy(g.standard_normal((B, S, N)).astype(np.float32)
                         ).to(cuda)
    dy = torch.from_numpy(g.standard_normal((B, S, D)).astype(np.float32)
                          ).to(cuda)
    dl = torch.from_numpy(g.standard_normal((B, D, N)).astype(np.float32)
                          ).to(cuda) if with_last else None
    got = cuda_mb.mamba_scan_bwd(at, bt, C, dy, dl)
    again = cuda_mb.mamba_scan_bwd(at, bt, C, dy, dl)
    want = ref.mamba_scan_bwd(at, bt, C, dy, dl)
    assert all(torch.equal(x, w) and torch.equal(x, y)
               for x, y, w in zip(got, again, want))


@pytest.mark.cuda
def test_autograd_launches_the_scan_backward_kernels(cuda):
    a = torch.rand(2, 40, 64, device=cuda).requires_grad_()
    b = torch.rand(2, 40, 64, device=cuda)
    a4 = torch.rand(2, 40, 64, 16, device=cuda).requires_grad_()
    C = torch.rand(2, 40, 16, device=cuda)
    kbuild.reset_launches()
    h = ops.rglru_scan(a, b)
    torch.autograd.grad(h[:, -1].clone().sum(), a)
    y, _ = ops.mamba_scan_with_state(a4, a4.detach(), C)
    torch.autograd.grad(y.sum(), a4)
    L = kbuild.LAUNCHES
    assert (L["rglru_scan"], L["rglru_scan_bwd"], L["mamba_scan"],
            L["mamba_scan_bwd"]) == (1, 1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHK + [(4, 512, 8192, 16)])
def test_mamba_checkpointing_forward_equals_twin_on_card(cuda, shape):
    """The checkpointing entry point leaves y and h_last equal to the
    Pallas-contract entry point's, and its checkpoints equal the twin's."""
    a, b, C, _, _ = (torch.from_numpy(x).to(cuda)
                     for x in _mamba_inputs(shape, 12))
    y, h_last, chk = cuda_mamba.mamba_scan_with_checkpoints(a, b, C)
    want_y, want_h = cuda_mamba.mamba_scan_with_state(a, b, C)
    assert torch.equal(y, want_y) and torch.equal(h_last, want_h)
    assert torch.equal(chk, ref.mamba_scan_checkpoints(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("with_last", [False, True])
@pytest.mark.parametrize("shape", CHK + [(4, 512, 8192, 16)])
def test_mamba_bwd_kernel_both_ways_equals_twin_on_card(cuda, shape,
                                                        with_last):
    """The backward kernel from the forward's checkpoints and standalone:
    da, db and dC equal to the twin, and to each other."""
    a, b, C, dy, dl = (torch.from_numpy(x).to(cuda)
                       for x in _mamba_inputs(shape, 13))
    dl = dl if with_last else None
    chk = cuda_mamba.mamba_scan_with_checkpoints(a, b, C)[2]
    got = cuda_mb.mamba_scan_bwd(a, b, C, dy, dl, chk)
    alone = cuda_mb.mamba_scan_bwd(a, b, C, dy, dl)
    want = ref.mamba_scan_bwd(a, b, C, dy, dl)
    assert all(torch.equal(x, w) and torch.equal(y, w)
               for x, y, w in zip(got, alone, want))


@pytest.mark.cuda
def test_mamba_bwd_wrapper_checks_the_checkpoints(cuda):
    a, b, C, dy, _ = (torch.from_numpy(x).to(cuda)
                      for x in _mamba_inputs((1, 2 * T + 1, 8, 4), 14))
    with pytest.raises(ValueError, match="h_chk"):
        cuda_mb.mamba_scan_bwd(a, b, C, dy, None,
                               torch.zeros(1, 1, 8, 4, device=cuda))
