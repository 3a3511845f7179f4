"""The port's swarmlint, ops tier (repro_torch.analysis.ops J001–J005), on
the CPU: the repo's programs recorded once for the module (every target,
every strategy, float32 and float64), the rules over them, parity with
the reference's jaxpr rules run live in a subprocess beside them, and
mutation tests.

The J rules lint what ``targets.py`` records — the real installed
``repro_torch`` — so, as for the reference's tier, the fixture-tree
pattern of the AST tier does not transplant: each rule instead gets a
small local program carrying exactly the defect (TP) and its closest
correct idiom (TN), recorded through the registry's own
``record32_64`` / ``TracedTarget`` path and fed to the rule function.
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import run
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.baseline import load_baseline
from repro_torch.analysis.ops import fingerprint as fpmod
from repro_torch.analysis.ops import run_ops
from repro_torch.analysis.ops.fingerprint import (check_j005, fingerprint_fn,
                                                  group_fingerprints,
                                                  structural_signature,
                                                  sweep_fingerprint_table)
from repro_torch.analysis.ops.record import Recorder
from repro_torch.analysis.ops.rules import (TARGETS_FILE, check_j001,
                                            check_j002, check_j003,
                                            check_j004)
from repro_torch.analysis.ops.targets import (STRATEGIES, TARGET_N, Target,
                                              TracedTarget, all_targets,
                                              record32_64, trace_targets,
                                              warm)
from repro_torch.configs import SwarmConfig
from repro_torch.fleet.sweep import SweepSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

#: the port's counterparts of the reference's baselined J001 sites
#: (analysis_baseline.toml:68-90)
J001_SITES = {("src/repro_torch/swarm/simulator.py", "_compute_pass"),
              ("src/repro_torch/swarm/transfer.py", "progress"),
              ("src/repro_torch/trace/record.py", "write_state")}


@pytest.fixture(scope="module")
def recorded():
    """The port's targets and stand-in sweeps recorded once on the CPU;
    meanwhile, in two subprocesses, the reference's J rules run live and
    ``python -m repro_torch.analysis --tier all --device cpu`` runs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    procs = {
        "reference": [sys.executable, os.path.join(
            REPO, "tests", "torch_lint", "reference_jrules.py"), REPO],
        "cli": [sys.executable, "-m", "repro_torch.analysis", "--root",
                REPO, "--tier", "all", "--device", "cpu"]}
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 env=env, cwd=REPO)
             for k, cmd in procs.items()}
    try:
        report = {}
        raw = run_ops(REPO, device="cpu", report=report)
        traced = trace_targets(device="cpu")        # the same recordings
        raw_all = run(REPO, use_baseline=False, tier="all", device="cpu")
        done = {k: (p.communicate(timeout=300), p.returncode)
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    (out, err), rc = done["reference"]
    assert rc == 0, err
    return {"traced": traced, "raw": raw, "raw_all": raw_all,
            "report": report, "reference": json.loads(out),
            "cli": done["cli"]}


# ---------------------------------------------------------------------------
# the shipped tree under the ops tier
# ---------------------------------------------------------------------------


def test_repo_tree_is_clean_under_ops_tier(recorded):
    """``--tier ops`` over the committed tree on the CPU: zero findings
    beyond the port's baseline."""
    findings = run(REPO, tier="ops", device="cpu")
    assert findings == [], "\n".join(
        f"{f.file}:{f.line}: {f.rule} [{f.symbol}] {f.message}"
        for f in findings)


def test_every_target_is_recorded(recorded):
    traced = recorded["traced"]
    assert sorted(traced) == recorded["reference"]["targets"]
    for name, tt in traced.items():
        want = STRATEGIES if name.startswith("sim_") else \
            tt.target.strategies
        assert tuple(tt.rec32) == tuple(want), name
        assert tt.err64 is None and set(tt.rec64) == set(tt.rec32), name
        assert all(len(r) > 0 for r in tt.rec32.values()), name
        # the float64 pass records as many calls (J002 compares them)
        for s, r32 in tt.rec32.items():
            assert len(r32) == len(tt.rec64[s]), (name, s)
    # on the CPU the φ launchers take their plain versions: no kernels
    assert all(not tt.kernels() for tt in traced.values())


def test_j001_fires_exactly_at_the_reference_counterparts(recorded):
    """The port's in-loop cross-node float reductions are the reference's
    three baselined ones, and no other."""
    sites = {(f.file, f.symbol) for f in recorded["raw"]
             if f.rule == "J001"}
    assert sites == J001_SITES


def test_j_rules_flag_the_reference_targets(recorded):
    """Per rule, the targets the port's J001–J004 flag are the ones the
    reference's flag when run live (J001: the five sim targets; J002–J004:
    none), and J005 flags no stand-in sweep in either."""
    traced, ref = recorded["traced"], recorded["reference"]
    for rid, check in (("J001", check_j001), ("J002", check_j002),
                       ("J003", check_j003), ("J004", check_j004)):
        port = sorted(name for name, tt in traced.items()
                      if list(check({name: tt}, REPO)))
        assert port == ref[rid], rid
    assert ref["J001"] == sorted(n for n in traced if n.startswith("sim_"))
    port_j005 = sorted(f.symbol for f in recorded["raw"] if f.rule == "J005")
    assert port_j005 == ref["J005"] == []


def test_repo_baseline_entries_all_fire(recorded):
    """Every [[allow]] entry of the port's baseline matches a live finding
    of one of the two tiers."""
    live = {(f.rule, f.file, f.symbol) for f in recorded["raw_all"]}
    bl = load_baseline(REPO)
    stale = [a for a in bl.allows_ if a not in live]
    assert stale == [], f"baseline entries with no live finding: {stale}"


def test_no_baseline_reports_exactly_the_baseline_entries(recorded):
    """Without the baseline the tree reports its [[allow]] entries and
    the digest-exempt spec fields, and nothing else."""
    got = {(f.rule, f.file, f.symbol) for f in recorded["raw_all"]}
    bl = load_baseline(REPO)
    exempt = {("R002", "src/repro_torch/fleet/sweep.py", field)
              for field in bl.digest_exempt
              if field.startswith("SweepSpec.")}
    assert got == set(bl.allows_) | exempt


def test_report_carries_recordings_and_sweeps(recorded):
    rep = recorded["report"]
    assert rep["device"] == "cpu" and rep["total_s"] > rep["targets_s"] > 0
    assert set(rep["targets"]) == {t.name for t in all_targets()}
    assert all(t["ops"] > 0 for t in rep["targets"].values())
    sweeps = {t["sweep"]: t for t in rep["sweeps"]}
    assert set(sweeps) == {"j005_gamma", "j005_load", "j005_sparse_gamma"}
    assert all(t["stable"] for t in sweeps.values())
    # gamma moves no program: one per strategy (the structural groups)
    assert sweeps["j005_gamma"]["distinct_programs"] == 2
    assert sweeps["j005_load"]["distinct_programs"] == 1


def test_cli_all_tiers_on_the_cpu_exit_zero(recorded, capsys):
    """``python -m repro_torch.analysis --tier all --device cpu`` exits 0
    on the repo (the module's subprocess); in process, reusing the
    module's recordings, ``--no-baseline`` reports the J001 sites."""
    (out, err), rc = recorded["cli"]
    assert rc == 0, out + err
    assert "swarmlint[all]: 0 finding(s)" in out
    assert cli_main(["--root", REPO, "--tier", "ops", "--device", "cpu",
                     "--no-baseline", "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert {f["rule"] for f in doc["findings"]} == {"J001"}


@pytest.mark.cuda
def test_ops_tier_on_the_card_records_the_phi_kernels():
    """On the card the sim targets record the fused φ kernels' launches:
    the audited program is the card's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    traced = trace_targets([t for t in all_targets()
                            if t.name in ("sim_dense", "sim_sparse")])
    assert traced["sim_dense"].kernels().get("phi_update", 0) > 0
    assert traced["sim_sparse"].kernels().get("phi_update_sparse", 0) > 0


# ---------------------------------------------------------------------------
# mutation programs
# ---------------------------------------------------------------------------


def _traced(fn, args, name="mut", n_axis=TARGET_N):
    """Record one local program through the registry's exact path and wrap
    it the way ``trace_target`` does — the rules' input contract."""
    t = Target(name, "sim", lambda d, s: (fn, args), n_axis=n_axis)
    warm(fn, args)
    r32, r64, err = record32_64(fn, args)
    return {name: TracedTarget(t, {None: r32},
                               {} if r64 is None else {None: r64}, err)}


def run_sim(xs):                 # the loop's scope, named as the port's
    acc = torch.zeros((), dtype=torch.float32)
    for x in xs:                 # x: [N] float32
        acc = acc + x.sum()      # a cross-node collapse in the loop
    return acc


def test_j001_true_positive_in_loop_float_sum():
    xs = torch.ones((5, TARGET_N), dtype=torch.float32)
    found = list(check_j001(_traced(run_sim, (xs,)), REPO))
    assert len(found) == 1
    f = found[0]
    assert f.rule == "J001" and "Tensor.sum" in f.message
    assert "mut" in f.message            # names the target it recorded
    # a test-module frame is not the port's: anchored at the registry
    assert (f.file, f.symbol) == (TARGETS_FILE, "mut")


def test_j001_true_positive_fsum_is_flagged():
    """fsum's f64 accumulation is not exact in every order: flagged like
    any other sum, at its caller's line (fp.py is a helper)."""
    from repro_torch.core.fp import fsum

    def run_sim(x):
        return fsum(x)

    found = list(check_j001(_traced(run_sim, (torch.ones(2, TARGET_N),)),
                            REPO))
    assert [f.rule for f in found] == ["J001"]


def test_j001_true_negative_exact_and_integer_reductions():
    """max (exact in any order) and integer sums are exempt, and per-node
    [N, N] -> [N] aggregations keep the axis."""
    def run_sim(xs):             # xs: [T, N, N] float32
        out = []
        for x in xs:
            out.append((x.sum(dim=1), x.amax(), x.argmin(),
                        (x > 0).sum(dtype=torch.int32), (x > 0).any()))
        return out

    xs = torch.ones((3, TARGET_N, TARGET_N), dtype=torch.float32)
    assert list(check_j001(_traced(run_sim, (xs,)), REPO)) == []


def test_j001_outside_the_loop_is_allowed():
    """The same collapse in ``summarize`` (or outside ``run_sim``) is the
    prescribed place, not a finding."""
    def summarize(ys):
        return ys.sum()

    def run_sim(xs):
        return summarize(xs * 2.0)

    xs = torch.ones((4, TARGET_N), dtype=torch.float32)
    assert list(check_j001(_traced(run_sim, (xs,)), REPO)) == []
    assert list(check_j001(_traced(lambda x: x.sum(), (xs,)), REPO)) == []


def test_j001_skips_targets_without_n_axis():
    xs = torch.ones((5, TARGET_N), dtype=torch.float32)
    assert list(check_j001(_traced(run_sim, (xs,), n_axis=None),
                           REPO)) == []


def test_j002_true_positive_default_dtype_leak():
    """An integer tensor promoted by a Python float takes torch's default
    dtype: float32 in one run, float64 in the other."""
    def fn(x):
        return x.long() * 0.5

    found = list(check_j002(_traced(fn, (torch.ones(3),)), REPO))
    assert len(found) == 1 and "dtype drift" in found[0].message
    assert found[0].rule == "J002" and found[0].symbol == "mut"


def test_j002_true_positive_raise_under_float64():
    """A kernel-style dtype check that passes only under the float32
    default (the φ kernels take float32) fails the float64 run."""
    from repro_torch.kernels.build import check

    def fn(x):
        y = torch.zeros(3)                       # unpinned factory
        check("y", y, torch.float32, (3,), CPU)
        return x + y

    found = list(check_j002(_traced(fn, (torch.ones(3),)), REPO))
    assert len(found) == 1
    assert "fails under the float64 default dtype (TypeError)" in \
        found[0].message


def test_j002_true_negative_pinned_dtypes():
    def fn(x):
        return (x * 2.0 + torch.zeros((), dtype=torch.float32)
                + torch.full((3,), 0.5, dtype=torch.float32))

    assert list(check_j002(_traced(fn, (torch.ones(3),)), REPO)) == []


_J003_SRC = textwrap.dedent("""\
    import torch


    def unannotated(x, idx):
        return x[idx.clamp(0, x.shape[0] - 1).long()]


    def annotated(x, idx):
        # oob: the clamp is deliberate — padded slots point past N
        return x[idx.clamp(0, x.shape[0] - 1).long()]


    def redirected(x, idx):
        slot = torch.where(idx < x.shape[0], idx, 0).long()
        return torch.gather(x, 0, slot)


    def merged(x, idx):
        # a where between two tensors is a masked update, not a redirect
        return x[torch.where(idx < x.shape[0], idx,
                             torch.zeros_like(idx)).long()]
""")


def _j003_traced(tmp_path, func_name):
    """Write the J003 module under a ``src/repro_torch/`` tree so its
    calls anchor to a repo-relative file, then record one function."""
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True, exist_ok=True)
    mod_path = pkg / "j003_mod.py"
    mod_path.write_text(_J003_SRC)
    spec = importlib.util.spec_from_file_location("j003_mod", str(mod_path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    args = (torch.ones(TARGET_N), torch.tensor([0, 5, 99]))
    return _traced(getattr(mod, func_name), args, name=f"j003_{func_name}")


@pytest.mark.parametrize("func,how", [("unannotated", "clamp-made"),
                                      ("redirected", "where-redirected")])
def test_j003_true_positive_unannotated_index(tmp_path, func, how):
    found = list(check_j003(_j003_traced(tmp_path, func), str(tmp_path)))
    assert len(found) == 1
    f = found[0]
    assert f.rule == "J003" and f.symbol == func
    assert f.file == "src/repro_torch/j003_mod.py"
    assert f.line > 0                    # anchored to a real source line
    assert how in f.message


@pytest.mark.parametrize("func", ["annotated", "merged"])
def test_j003_true_negative(tmp_path, func):
    assert list(check_j003(_j003_traced(tmp_path, func),
                           str(tmp_path))) == []


def test_j004_true_positive_big_host_table():
    big = np.zeros((600, 600), np.float32)       # 1.44 MB > 1 MiB cap

    def fn(x):
        return x + torch.as_tensor(big).sum()

    found = list(check_j004(_traced(fn, (torch.ones(3),)), REPO))
    assert len(found) == 1
    assert found[0].rule == "J004"
    assert "host-data bloat" in found[0].message


def test_j004_true_negative_small_host_data():
    def fn(x):
        return x + torch.tensor([0.5] * TARGET_N,
                                dtype=torch.float32).sum()

    assert list(check_j004(_traced(fn, (torch.ones(3),)), REPO)) == []


def test_kernel_launch_is_an_event():
    """A counted launch (``kernels/build.py``'s ``launched``) puts a
    ``kernel:`` event in the active recording, and only there."""
    from repro_torch.kernels import build
    from repro_torch.kernels import diffusive_phi  # noqa: F401 (registers)
    before = build.LAUNCHES["phi_update"]
    try:
        with Recorder() as rec:
            build.launched(0, "phi_update")
        build.launched(0, "phi_update")          # no recorder: no event
        assert rec.recording().kernels() == {"phi_update": 1}
        assert build.LAUNCHES["phi_update"] == before + 2
        assert build.LAUNCH_OBSERVERS == []
    finally:
        build.LAUNCHES["phi_update"] = before


# ---------------------------------------------------------------------------
# J005 — op-stream fingerprints
# ---------------------------------------------------------------------------


def test_fingerprint_abstracts_float_values():
    """Data differences vanish: the same program with other Python float
    values shares a fingerprint; a different program does not."""
    x = torch.ones(3)
    fp_a = fingerprint_fn(lambda v: v * 2.0, x)
    fp_b = fingerprint_fn(lambda v: v * 3.5, x)
    fp_c = fingerprint_fn(lambda v: v * 2.0 + 1.0, x)
    assert fp_a == fp_b
    assert fp_a != fp_c


def test_fingerprint_abstracts_tensor_values_not_shapes():
    a = torch.arange(4, dtype=torch.float32)
    b = a * 7.0
    fp_a = fingerprint_fn(lambda v: v + a, torch.ones(4))
    fp_b = fingerprint_fn(lambda v: v + b, torch.ones(4))
    assert fp_a == fp_b
    assert fingerprint_fn(lambda v: v + 1.0, torch.ones(4)) != \
        fingerprint_fn(lambda v: v + 1.0, torch.ones(5))


def test_fingerprint_sees_kernel_launches():
    from repro_torch.kernels import build
    from repro_torch.kernels import diffusive_phi  # noqa: F401 (registers)
    before = build.LAUNCHES["phi_update"]
    try:
        def launches(v):
            build.launched(0, "phi_update")
            return v + 1.0
        assert fingerprint_fn(launches, torch.ones(3)) != \
            fingerprint_fn(lambda v: v + 1.0, torch.ones(3))
    finally:
        build.LAUNCHES["phi_update"] = before


def test_structural_signature_splits_data_from_structure():
    base = SwarmConfig(num_workers=13, sim_time_s=1.0, num_runs=2)
    spec = SweepSpec.build("sig", base, axes={"gamma": (0.01, 0.05)},
                           strategies=(0, 4), num_runs=2)
    sigs = {structural_signature(p) for p in spec.expand()}
    # gamma is data-like; the strategy is structural in the port (a
    # Python branch): one signature per strategy
    assert len(sigs) == 2
    spec8 = SweepSpec.build("sig8", base, axes={"gamma": (0.01,)},
                            num_runs=8)
    assert structural_signature(spec8.expand()[0]) not in sigs
    import dataclasses
    longer = dataclasses.replace(base, sim_time_s=2.0)
    spec_t = SweepSpec.build("sigt", longer, axes={"gamma": (0.01,)},
                             strategies=(4,), num_runs=2)
    assert structural_signature(spec_t.expand()[0]) not in sigs


def test_group_fingerprints_verdicts():
    sig = (("n", 13), ("num_runs", 2))
    rows = [(sig, "a", "fp1"), (sig, "b", "fp1"), (sig, "c", "fp2"),
            ((("n", 26),), "d", "fp3")]
    groups = {len(g["points"]): g for g in group_fingerprints(rows)}
    big, lone = groups[3], groups[1]
    assert not big["stable"] and big["distinct_programs"] == 2
    assert sorted(big["programs"]["fp1"]) == ["a", "b"]
    assert lone["stable"] and lone["distinct_programs"] == 1


def test_j005_true_negative_data_only_sweep_is_stable(recorded):
    """A real data-only sweep over the real simulator runs one program
    (its points were recorded by the module's J005 pass)."""
    base = SwarmConfig(num_workers=13, sim_time_s=1.0, num_runs=2)
    spec = SweepSpec.build("tn_gamma", base, axes={"gamma": (0.01, 0.05)},
                           strategies=(4,), num_runs=2)
    table = sweep_fingerprint_table(spec, device="cpu")
    assert table["stable"]
    assert table["distinct_programs"] == 1
    assert table["unstable_groups"] == []
    assert set(table["points"]) == {p.label for p in spec.expand()}


def test_j005_true_positive_leaked_static_arg(monkeypatch):
    """A sweep whose data-like axis leaks into the program (fingerprint
    depends on gamma) is named by check_j005 — the signal a host branch
    ``if gamma > x:`` in the loop would give."""
    base = SwarmConfig(num_workers=13, sim_time_s=1.0, num_runs=2)
    leaky = SweepSpec.build("leaky", base, axes={"gamma": (0.01, 0.05)},
                            strategies=(4,), num_runs=2)
    monkeypatch.setattr(fpmod, "_standin_specs", lambda: [leaky])
    monkeypatch.setattr(fpmod, "point_fingerprint",
                        lambda p, device=None: f"leak-{p.cfg.gamma}")
    found = list(check_j005({}, REPO, device="cpu"))
    assert len(found) == 1
    f = found[0]
    assert f.rule == "J005"
    assert f.file == "src/repro_torch/fleet/sweep.py"
    assert f.symbol == "sweep:leaky"
    assert "2 distinct programs" in f.message


def test_sweep_fingerprint_table_caps_points(monkeypatch):
    base = SwarmConfig(num_workers=13, sim_time_s=1.0, num_runs=2)
    spec = SweepSpec.build("cap", base,
                           axes={"gamma": (0.01, 0.02, 0.05)}, num_runs=2)
    monkeypatch.setattr(fpmod, "point_fingerprint",
                        lambda p, device=None: "fp")
    table = sweep_fingerprint_table(spec, max_points=2, device="cpu")
    assert table["skipped_points"] == 1
    assert len(table["points"]) == 2
