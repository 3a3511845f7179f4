"""The two backward kernels of the port (flash attention, rmsnorm), their
plain twins and their ``torch.autograd.Function`` wiring.

* On the CPU: ``ref.flash_attention_bwd`` and ``ref.rmsnorm_bwd`` (explicit
  f32 math) against torch autograd of the plain forwards and against
  ``jax.vjp`` of the JAX package's plain ``flash_attention`` and
  ``rmsnorm`` (GQA, windows, Sq != Sk, float32 and bfloat16): rtol = atol =
  3e-5 in float32 on outputs of order one (the two libraries sum in other
  orders), and 2e-2 in bfloat16 (each side rounds its result to bf16, and
  autograd of the forward also rounds P to bf16 before P·V), as
  tests/test_kernels.py holds the forward kernels.  ``ops.FlashAttention``
  and ``ops.RMSNorm`` run on the CPU with the plain versions injected, and
  give the plain twins' gradients exactly; the launch plan of the rmsnorm
  backward is one the kernel has, and the bf16 flash backward's plan
  covers every head and tile once with a head split that divides G.
* On the card (marker ``cuda``, skipped without one): each kernel against
  its plain twin at those tolerances, two launches bit-equal; the
  autograd Functions launch the backward kernels; decode attention and
  the φ kernels raise under autograd.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as cuda_fb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm_bwd as cuda_nb  # noqa: E402

torch.set_num_threads(1)
TOL = {"float32": 3e-5, "bfloat16": 2e-2}
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FLASH = [  # B, Sq, Sk, Hq, Hkv, hd, causal, window
    (2, 16, 16, 4, 2, 16, True, 0),
    (1, 24, 24, 4, 1, 32, True, 5),
    (2, 20, 33, 4, 2, 16, True, 0),
    (1, 33, 20, 2, 2, 16, False, 0),
    (2, 16, 16, 4, 4, 32, False, 6),
]
NORMS = [(4, 64), (3, 5, 128), (7, 100), (2, 3, 8)]


def _flash_inputs(shape, dt, seed=0):
    B, Sq, Sk, Hq, Hkv, hd, _, _ = shape
    g = np.random.default_rng(seed)
    arrs = [g.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd),
                      (B, Sq, Hq, hd))]
    return [torch.from_numpy(a).to(DT[dt]) for a in arrs]


def _close(got, want, dt, what=""):
    tol = TOL[dt]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(
        want, np.float32) if not torch.is_tensor(want)
        else want.float().numpy(), rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH)
def test_flash_bwd_plain_matches_autograd_and_jax(shape, dt):
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    jref = pytest.importorskip("repro.kernels.ref")
    *_, causal, window = shape
    q, k, v, do = _flash_inputs(shape, dt)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ref.flash_attention(*leaves, causal=causal, window=window)
    auto = torch.autograd.grad(o, leaves, do)
    mine = ref.flash_attention_bwd(q, k, v, o.detach().contiguous(), do,
                                   causal=causal, window=window)

    def jf(q_, k_, v_):
        return jref.flash_attention(q_, k_, v_, causal=causal, window=window)

    jd = jnp.float32 if dt == "float32" else jnp.bfloat16
    ja = [jnp.asarray(t.float().numpy()).astype(jd) for t in (q, k, v)]
    _, vjp = jax.vjp(jf, *ja)
    jg = vjp(jnp.asarray(do.float().numpy()).astype(jd))
    for name, m, a, j in zip(("dq", "dk", "dv"), mine, auto, jg):
        assert m.dtype == q.dtype
        _close(m, a, dt, f"{name} against autograd")
        _close(m, np.asarray(j.astype(jnp.float32)), dt,
               f"{name} against jax.vjp")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NORMS)
def test_rmsnorm_bwd_plain_matches_autograd_and_jax(shape, dt):
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    jref = pytest.importorskip("repro.kernels.ref")
    g = np.random.default_rng(1)
    x = torch.from_numpy(g.standard_normal(shape).astype(np.float32)
                         ).to(DT[dt])
    s = torch.from_numpy(g.standard_normal(shape[-1]).astype(np.float32))
    dy = torch.from_numpy(g.standard_normal(shape).astype(np.float32)
                          ).to(DT[dt])
    xl, sl = x.clone().requires_grad_(), s.clone().requires_grad_()
    auto = torch.autograd.grad(ref.rmsnorm(xl, sl), (xl, sl), dy)
    dx, dscale = ref.rmsnorm_bwd(x, s, dy)
    assert dx.dtype == x.dtype and dscale.dtype == torch.float32
    jd = jnp.float32 if dt == "float32" else jnp.bfloat16
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b),
                     jnp.asarray(x.float().numpy()).astype(jd),
                     jnp.asarray(s.numpy()))
    jdx, jds = vjp(jnp.asarray(dy.float().numpy()).astype(jd))
    # dscale sums over the rows: held relative to its largest entry
    scale = float(auto[1].abs().max())
    _close(dx, auto[0], dt, "dx against autograd")
    _close(dx, np.asarray(jdx.astype(jnp.float32)), dt, "dx against jax")
    for want in (auto[1], torch.from_numpy(np.array(jds, np.float32))):
        np.testing.assert_allclose(dscale.numpy(), want.numpy(), rtol=0,
                                   atol=TOL[dt] * max(1.0, scale))


def test_flash_function_wiring_on_the_cpu():
    """``FlashAttention`` with the plain versions injected: the forward is
    the plain forward, the gradients are the plain twin's, exactly."""
    shape = (2, 20, 33, 4, 2, 16, True, 3)
    q, k, v, do = _flash_inputs(shape, "float32", seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.FlashAttention.apply(*leaves, True, 3, ref.flash_attention,
                                 ref.flash_attention_bwd)
    assert torch.equal(o, ref.flash_attention(q, k, v, window=3))
    got = torch.autograd.grad(o, leaves, do)
    want = ref.flash_attention_bwd(q, k, v, o.detach(), do, window=3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_rmsnorm_function_wiring_on_the_cpu():
    g = np.random.default_rng(4)
    x = torch.from_numpy(g.standard_normal((3, 5, 64)).astype(np.float32))
    s = torch.from_numpy(g.standard_normal(64).astype(np.float32))
    dy = torch.from_numpy(g.standard_normal((3, 5, 64)).astype(np.float32))
    xl, sl = x.clone().requires_grad_(), s.clone().requires_grad_()
    y = ops.RMSNorm.apply(xl, sl, 1e-6, ref.rmsnorm, ref.rmsnorm_bwd)
    assert torch.equal(y, ref.rmsnorm(x, s))
    got = torch.autograd.grad(y, (xl, sl), dy)
    want = ref.rmsnorm_bwd(x, s, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cpu_tensors_take_plain_autograd():
    """On the CPU ``ops.flash_attention`` and ``ops.rmsnorm`` are the plain
    versions (autograd differentiates them); the wrappers of the kernels
    refuse CPU tensors."""
    q, k, v, do = _flash_inputs(FLASH[0], "float32")
    ql = q.clone().requires_grad_()
    o = ops.flash_attention(ql, k, v)
    assert not isinstance(o.grad_fn, ops.FlashAttention._backward_cls)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_fb.flash_attention_bwd(q, k, v, o.detach(), do)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_nb.rmsnorm_bwd(q, torch.ones(16), do)


@pytest.mark.parametrize("d", [1, 8, 100, 128, 256, 257, 512, 1000, 1024,
                               1536, 2048, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 4, 255, 256, 2048, 32768])
def test_rmsnorm_bwd_plan_is_one_the_kernel_has(rows, d):
    """For both dtypes: the kernel instantiates (1: 1, 2), (2 to 512: 2)
    and (512: 4) threads a row and chunks a thread; the rows a block are a
    multiple of the rows its 512 threads take at once; the blocks cover
    every row; the groups of the two-level dscale sum cover every block
    once, with one ticket a group and one more."""
    have = {(1, 1), (1, 2), (512, 4)} | {(1 << i, 2) for i in range(1, 10)}
    for dt in (torch.float32, torch.bfloat16):
        tpr, nv, rpb, n_part, group = cuda_nb.bwd_plan(rows, d, dt)
        vec = 16 // torch.empty((), dtype=dt).element_size()
        assert (tpr, nv) in have
        assert tpr * nv * vec >= d > (tpr * nv // 2) * vec or tpr * nv == 1
        assert rpb % max(1, cuda_nb.BLOCK // tpr) == 0
        assert rpb * n_part >= rows > rpb * (n_part - 1)
        assert n_part <= cuda_nb.PARTIALS or rpb == max(1, cuda_nb.BLOCK
                                                        // tpr)
        n_groups = -(-n_part // group)
        assert group * n_groups >= n_part > group * (n_groups - 1)
        assert max(group, n_groups) <= math.isqrt(n_part - 1) + 1
        assert cuda_nb.bwd_plan(rows, d, dt) == (tpr, nv, rpb, n_part, group)


FLASH_PLANS = [  # B, Sq, Sk, Hq, Hkv, hd: the trained models at 4 x 512,
    #               recurrentgemma's, and ragged shapes
    *[(4, 512, 512, c.num_heads, c.num_kv_heads, c.head_dim_)
      for c in map(get_config, ("qwen3-1.7b", "granite-moe-1b-a400m",
                                "qwen2-vl-2b", "recurrentgemma-9b"))],
    (2, 200, 328, 4, 2, 128), (2, 328, 200, 4, 2, 64),
    (1, 1000, 1000, 4, 1, 256), (2, 150, 90, 4, 4, 32), (2, 77, 77, 4, 2, 16),
]


@pytest.mark.parametrize("shape", FLASH_PLANS)
def test_flash_bwd_plan_covers_each_head_and_tile_once(shape, monkeypatch):
    """The bf16 kernels' plan: every (batch, query head, key tile) is one
    dK/dV block's, every (batch, query head, query tile) one dQ block's;
    the head split divides G; the plan is a function of the shapes alone
    (the card is never asked)."""
    B, Sq, Sk, Hq, Hkv, hd = shape

    def no_card(*a, **k):
        raise AssertionError("the plan asked the card")
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(kbuild, "sm_count", no_card)
    plan = cuda_fb.bwd_plan(*shape)
    assert plan == cuda_fb.bwd_plan(*shape)
    G = Hq // Hkv
    assert G % plan.hs == 0
    assert plan.k_tiles == -(-Sk // plan.tile)
    assert plan.q_tiles == -(-Sq // plan.tile)
    assert plan.sq_pad == plan.q_tiles * plan.tile >= Sq
    seen = []
    for x in range(plan.dkdv_grid[0]):
        for y in range(plan.dkdv_grid[1]):
            b, hk, heads, kt = plan.dkdv_block(x, y)
            assert all(h // G == hk for h in heads)
            seen += [(b, h, kt) for h in heads]
    assert sorted(seen) == [(b, h, kt) for b in range(B) for h in range(Hq)
                            for kt in range(plan.k_tiles)]
    for causal in (True, False):
        seen = sorted(plan.dq_block(x, y, causal)
                      for x in range(plan.dq_grid[0])
                      for y in range(plan.dq_grid[1]))
        assert seen == [(b, h, qt) for b in range(B) for h in range(Hq)
                        for qt in range(plan.q_tiles)]
    blocks = plan.dkdv_grid[0] * plan.dkdv_grid[1]
    assert blocks >= cuda_fb.WAVES or plan.hs == G
    smaller = [h for h in range(1, plan.hs) if G % h == 0]
    assert all(blocks // plan.hs * h < cuda_fb.WAVES for h in smaller)
    split = plan.hs > 1
    assert plan.partial == (2 * plan.hs * B * Sk * Hkv * hd if split else 0)
    assert plan.tickets == (B * Hkv * plan.k_tiles if split else 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH + [(2, 130, 200, 8, 2, 128, True, 0),
                                           (1, 100, 100, 4, 1, 256, True, 64),
                                           (2, 77, 77, 4, 2, 64, True, 0),
                                           (4, 512, 512, 16, 1, 256, True, 0),
                                           (4, 512, 512, 12, 2, 128, True, 0)])
def test_flash_bwd_kernel_matches_plain_on_card(cuda, shape, dt):
    *_, causal, window = shape
    q, k, v, do = [t.to(cuda) for t in _flash_inputs(shape, dt)]
    o = ref.flash_attention(q, k, v, causal=causal, window=window
                            ).contiguous()
    got = cuda_fb.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                      window=window)
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                   window=window)
    again = cuda_fb.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                        window=window)
    for a, b, c in zip(got, want, again):
        _close(a.cpu(), b.cpu(), dt)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NORMS + [(2048, 4096), (4, 512, 16, 128)])
def test_rmsnorm_bwd_kernel_matches_plain_on_card(cuda, shape, dt):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, device=cuda, generator=g).to(DT[dt])
    s = torch.randn(shape[-1], device=cuda, generator=g)
    dy = torch.randn(shape, device=cuda, generator=g).to(DT[dt])
    got = cuda_nb.rmsnorm_bwd(x, s, dy)
    want = ref.rmsnorm_bwd(x, s, dy)
    again = cuda_nb.rmsnorm_bwd(x, s, dy)
    _close(got[0].cpu(), want[0].cpu(), dt)
    scale = float(want[1].abs().max())
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=0, atol=TOL[dt] * max(1.0, scale))
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.cuda
def test_autograd_functions_launch_the_backward_kernels(cuda):
    q, k, v, do = [t.to(cuda) for t in _flash_inputs(
        (2, 64, 64, 4, 2, 64, True, 0), "bfloat16")]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    kbuild.reset_launches()
    o = ops.flash_attention(*leaves)
    torch.autograd.grad(o, leaves, do)
    x = torch.randn(8, 256, device=cuda).requires_grad_()
    y = ops.rmsnorm(x, torch.ones(256, device=cuda))
    torch.autograd.grad(y, x, torch.ones_like(y))
    L = kbuild.LAUNCHES
    assert (L["flash_attention"], L["flash_attention_bwd"],
            L["rmsnorm"], L["rmsnorm_bwd"]) == (1, 1, 1, 1)


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_autograd(cuda):
    """Decode attention and the φ updates have no backward kernel; the
    scans have one since (tests/test_torch_scan_grads.py)."""
    q = torch.randn(2, 4, 64, device=cuda).requires_grad_()
    kv = torch.randn(2, 32, 2, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        ops.decode_attention(q, kv, kv, 10)
    phi = (torch.rand(2, 8, device=cuda) + 1).requires_grad_()
    adj = torch.rand(2, 8, 8, device=cuda) < 0.5
    with pytest.raises(NotImplementedError, match="phi_update"):
        ops.phi_update(phi, torch.ones(2, 8, device=cuda), adj,
                       torch.rand(2, 8, 8, device=cuda))
    with torch.no_grad():                  # without grad mode they launch
        ops.decode_attention(q, kv, kv, 10)
