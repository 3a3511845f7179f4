"""The port's swarmlint, AST tier (repro_torch.analysis R001–R004): the
clean tree, per-rule fixtures, the baseline, SARIF, the CLI contract, and
parity with the live reference linter over the reference's own tree.

The fixture mini-repos under ``tests/torch_lint/analysis_fixtures/`` are
the reference's ``tests/analysis_fixtures/`` translated to the port's
idiom; each carries one rule's defect (``*_tp``) or the closest correct
idiom (``*_tn``) and goes through :func:`repro_torch.analysis.run`, the
code path of the CLI.
"""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.analysis import (ALL_RULE_IDS, OPS_RULE_IDS, RULE_DOCS, RULES,
                                  run)
from repro_torch.analysis.astutil import Finding, Tree
from repro_torch.analysis.baseline import (BASELINE_NAME, load_baseline,
                                           parse_baseline,
                                           prune_baseline_text)
from repro_torch.analysis.sarif import SARIF_VERSION, to_sarif

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_lint", "analysis_fixtures")


def fixture(name):
    return os.path.join(FIXTURES, name)


def run_rule(root, rule):
    return run(root, rules=[rule])


def _cli(*argv, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=120)


def _show(findings):
    return "\n".join(f"{f.file}:{f.line}: {f.rule} [{f.symbol}] {f.message}"
                     for f in findings)


# ---------------------------------------------------------------------------
# the shipped tree is clean
# ---------------------------------------------------------------------------


def test_repo_tree_is_clean():
    """Zero AST findings beyond the port's baseline — the assertion
    ``python -m repro_torch.analysis`` makes."""
    findings = run(REPO)
    assert findings == [], _show(findings)


def test_tree_subjects_are_the_port_only():
    """The subjects are ``src/repro_torch/`` (never the reference, which
    has its own linter), the evidence the port's tests and chip_smoke.py."""
    tree = Tree.load(REPO)
    subjects = [m.path for m in tree.src_modules()]
    assert subjects and all(p.startswith("src/repro_torch/")
                            for p in subjects)
    assert "src/repro_torch/swarm/simulator.py" in subjects
    assert not any(p.startswith("src/repro/") for p in tree.modules)
    evidence = [p for p in tree.modules if not p.startswith("src/")]
    assert "chip_smoke.py" in evidence
    assert all(p == "chip_smoke.py" or p.startswith("tests/test_torch_")
               for p in evidence)
    assert not any("analysis_fixtures" in p for p in tree.modules)


def test_repo_baseline_ast_entries_all_fire():
    """Every AST [[allow]] entry matches a live finding (the ops-tier
    entries are checked by tests/test_torch_analysis_ops.py, which records
    the programs)."""
    raw = run(REPO, use_baseline=False)
    live = {(f.rule, f.file, f.symbol) for f in raw}
    bl = load_baseline(REPO)
    assert bl is not None and bl.path.endswith(BASELINE_NAME)
    stale = [a for a in bl.allows_ if a[0] in RULES and a not in live]
    assert stale == [], f"baseline entries with no live finding: {stale}"


# ---------------------------------------------------------------------------
# parity with the reference's live linter
# ---------------------------------------------------------------------------

#: (rule, port file, symbol) the port does not report though the
#: reference does at the counterpart, each with its reason
ONLY_REFERENCE = {
    # the port takes kd, kt and the fold_in(11/13/17) scenario keys as
    # rows of one split of 18 (bit-identical under the partitionable
    # threefry), so the epoch key is consumed once
    ("R001", "src/repro_torch/swarm/simulator.py", "_epoch:key"),
}
#: (rule, port file, symbol) the port reports and the reference cannot:
#: R003's host-read rule (.item() / .cpu() / .numpy() …), which has no
#: counterpart inside jit, where a read raises
ONLY_PORT = {
    ("R003", "src/repro_torch/kernels/decode_attention.py",
     "decode_attention"),
    ("R003", "src/repro_torch/models/attention.py", "decode_attention_ref"),
    ("R003", "src/repro_torch/obs/hist.py", "_np"),
}


def _port_path(path):
    return "src/repro_torch/" + path[len("src/repro/"):]


def test_ast_findings_match_the_reference():
    """The reference's live AST findings over ``src/repro/``, paths mapped
    to ``src/repro_torch/``, equal the port's (both without a baseline),
    but for the listed differences."""
    from repro.analysis import run as ref_run
    ref = {(f.rule, _port_path(f.file), f.symbol)
           for f in ref_run(REPO, use_baseline=False)
           if f.file.startswith("src/repro/")}
    port = {(f.rule, f.file, f.symbol)
            for f in run(REPO, use_baseline=False)}
    assert ONLY_REFERENCE <= ref and not ONLY_REFERENCE & port
    assert ONLY_PORT <= port and not ONLY_PORT & ref
    assert port - ONLY_PORT == ref - ONLY_REFERENCE, (
        sorted(port - ONLY_PORT - ref), sorted(ref - ONLY_REFERENCE - port))
    assert {r for r, _, _ in ref} >= {"R001", "R002"}


# ---------------------------------------------------------------------------
# R001 — key discipline
# ---------------------------------------------------------------------------


def test_r001_true_positive():
    found = run_rule(fixture("r001_tp"), "R001")
    symbols = {f.symbol for f in found}
    assert symbols == {"sample_pair:key", "split_then_reuse:k1",
                       "row_reuse:k[..., 0, :]"}
    assert all(f.rule == "R001" for f in found)


def test_r001_true_negative():
    assert run_rule(fixture("r001_tn"), "R001") == []


def test_r001_rows_of_a_split_are_keys(tmp_path):
    """Taking several rows of one split is no reuse of the split; a row
    bound to a name and used twice is."""
    pkg = tmp_path / "src" / "repro_torch" / "swarm"
    pkg.mkdir(parents=True)
    (pkg / "rows.py").write_text(
        "from repro_torch import rng as R\n\n\n"
        "def f(key):\n"
        "    k = R.split(key, 2)\n"
        "    a, b = k[..., 0, :], k[..., 1, :]\n"
        "    return R.normal(a, (1,)) + R.normal(b, (1,)) "
        "+ R.uniform(b, (1,))\n")
    found = run_rule(str(tmp_path), "R001")
    assert [f.symbol for f in found] == ["f:b"]


# ---------------------------------------------------------------------------
# R002 — digest completeness
# ---------------------------------------------------------------------------


def test_r002_true_positive():
    found = run_rule(fixture("r002_tp"), "R002")
    assert [f.symbol for f in found] == ["SwarmConfig.trace_capacity"]
    assert "point_digest" in found[0].message


def test_r002_true_negative():
    # wholesale asdict coverage + a justified SweepSpec.name exemption
    assert run_rule(fixture("r002_tn"), "R002") == []


def test_r002_new_field_without_coverage_fails(tmp_path):
    """Adding a SwarmConfig field to a tree whose digest enumerates fields
    explicitly must fail R002 until the field is digested or exempted.
    The tmp tree uses the port's *real* configs.py plus a generated
    explicit-enumeration ``point_digest``, so the test tracks the live
    field list."""
    cfg_src = os.path.join(REPO, "src", "repro_torch", "configs.py")
    cls = next(n for n in ast.parse(open(cfg_src).read()).body
               if isinstance(n, ast.ClassDef) and n.name == "SwarmConfig")
    fields = [st.target.id for st in cls.body
              if isinstance(st, ast.AnnAssign)
              and isinstance(st.target, ast.Name)]
    assert len(fields) > 10     # sanity: we really parsed the dataclass

    dst = tmp_path / "src" / "repro_torch"
    (dst / "fleet").mkdir(parents=True)
    shutil.copy(cfg_src, dst / "configs.py")
    lines = [f'        "{f}": point.cfg.{f},' for f in fields]
    (dst / "fleet" / "store.py").write_text(
        "import hashlib, json\n\n\n"
        "def point_digest(point, version=None):\n"
        "    payload = {\n" + "\n".join(lines) + "\n"
        '        "code_version": version,\n'
        "    }\n"
        "    return hashlib.sha256(json.dumps(\n"
        "        payload, sort_keys=True).encode()).hexdigest()\n")

    assert run_rule(str(tmp_path), "R002") == []    # fully enumerated

    src = (dst / "configs.py").read_text().replace(
        "    trace_state_nodes: int = 0\n",
        "    trace_state_nodes: int = 0\n    brand_new_knob: int = 0\n")
    (dst / "configs.py").write_text(src)
    found = run_rule(str(tmp_path), "R002")
    assert [f.symbol for f in found] == ["SwarmConfig.brand_new_knob"]


def test_r002_stale_and_shadowed_exemptions(tmp_path):
    """An exemption naming no field, no live parameter, or a field that
    is in fact digested is itself a finding."""
    shutil.copytree(fixture("r002_tn"), tmp_path / "repo")
    root = tmp_path / "repo"
    (root / BASELINE_NAME).write_text(
        '[[digest_exempt]]\nfield = "SweepSpec.name"\nreason = "label"\n\n'
        '[[digest_exempt]]\nfield = "SwarmConfig.tick_s"\n'
        'reason = "shadowed"\n\n'
        '[[digest_exempt]]\nfield = "SweepSpec.gone"\nreason = "stale"\n\n'
        '[[digest_exempt]]\nfield = "point_digest.nope"\n'
        'reason = "stale parameter"\n')
    found = {f.symbol: f.message for f in run_rule(str(root), "R002")}
    assert set(found) == {"SwarmConfig.tick_s", "SweepSpec.gone",
                          "point_digest.nope"}
    assert "shadowed" in found["SwarmConfig.tick_s"]
    assert "stale" in found["SweepSpec.gone"]


# ---------------------------------------------------------------------------
# R003 — loop purity
# ---------------------------------------------------------------------------


def test_r003_true_positive():
    found = run_rule(fixture("r003_tp"), "R003")
    assert [f.symbol for f in found] == ["_stamp", "_sync"]
    stamp, sync = found
    # the chain starts at whichever root reached it first (_epoch is a
    # root in its own right) and ends at the offending function
    assert "-> _stamp" in stamp.message and "time.time" in stamp.message
    assert "host read '.item()'" in sync.message


def test_r003_true_negative():
    # host_report calls print()/time.time()/.cpu() but is unreachable
    assert run_rule(fixture("r003_tn"), "R003") == []


def test_r003_registry_dict_callables_are_roots():
    """A model registered in a registry dict literal is a dispatch target
    of the loop: its np.random call is a finding."""
    found = run_rule(fixture("r003_registry_tp"), "R003")
    assert [f.symbol for f in found] == ["_ghost_step"]
    assert "numpy.random.uniform" in found[0].message


# ---------------------------------------------------------------------------
# R004 — registry/doc consistency
# ---------------------------------------------------------------------------


def test_r004_true_positive():
    found = run_rule(fixture("r004_tp"), "R004")
    msgs = "\n".join(f.message for f in found)
    # the reference-side test_ghost.py is no evidence for the port
    assert "referenced by no test" in msgs
    assert "not mentioned in DESIGN.md" in msgs
    assert any(f.symbol == "cite:§42" for f in found)
    assert {f.symbol for f in found} == {"mobility:ghost_walk_model",
                                         "cite:§42"}


def test_r004_true_negative():
    # the mobility key documented in DESIGN.md, the strategies in the
    # README's port section, all named by a test_torch_*.py
    assert run_rule(fixture("r004_tn"), "R004") == []


def test_r004_readme_outside_the_port_section_does_not_count(tmp_path):
    shutil.copytree(fixture("r004_tn"), tmp_path / "repo")
    readme = tmp_path / "repo" / "README.md"
    readme.write_text(readme.read_text().replace(
        "## Running the port\n\nThe strategies `LocalOnly` and "
        "`Distributed`.\n", "## Running the port\n\n(nothing)\n").replace(
        "Nothing here counts", "`LocalOnly` and `Distributed` here do "
        "not count"))
    found = run_rule(str(tmp_path / "repo"), "R004")
    assert {f.symbol for f in found} == {"strategy:LocalOnly",
                                         "strategy:Distributed"}


# ---------------------------------------------------------------------------
# baseline parsing contract
# ---------------------------------------------------------------------------


def test_baseline_rejects_missing_reason():
    with pytest.raises(ValueError, match="reason"):
        parse_baseline('[[allow]]\nrule = "R001"\nfile = "f.py"\n'
                       'symbol = "f:key"\nreason = ""\n')
    with pytest.raises(ValueError, match="missing"):
        parse_baseline('[[digest_exempt]]\nfield = "SweepSpec.name"\n')


def test_baseline_matches_without_line_numbers():
    bl = parse_baseline('[[allow]]\nrule = "R001"\nfile = "a.py"\n'
                        'symbol = "f:key"\nreason = "why"\n')
    assert bl.allows(Finding("R001", "a.py", 1, "f:key", "m"))
    assert bl.allows(Finding("R001", "a.py", 999, "f:key", "m"))
    assert not bl.allows(Finding("R003", "a.py", 1, "f:key", "m"))


def test_repo_baseline_entries_carry_reasons():
    """Every entry of the port's baseline has a reason; the ones that
    counterpart an entry of the reference's cite its line there."""
    import tomllib
    with open(os.path.join(REPO, BASELINE_NAME), "rb") as f:
        doc = tomllib.load(f)
    entries = doc["allow"] + doc["digest_exempt"]
    assert entries and all(e["reason"].strip() for e in entries)
    ref = open(os.path.join(REPO, "analysis_baseline.toml")).read()
    ref_lines = ref.splitlines()
    for e in entries:
        if "analysis_baseline.toml:" in e["reason"]:
            n = int(e["reason"].rsplit("analysis_baseline.toml:", 1)[1]
                    .rstrip(")"))
            anchor = e.get("symbol") or e["field"]
            assert anchor in ref_lines[n - 1], (e, ref_lines[n - 1])
    assert all(e["file"].startswith("src/repro_torch/")
               for e in doc["allow"])


# ---------------------------------------------------------------------------
# SARIF emission
# ---------------------------------------------------------------------------


def test_sarif_document_shape():
    findings = [
        Finding("R001", "src/repro_torch/a.py", 12, "f:key", "key reuse"),
        Finding("J002", "src/repro_torch/analysis/ops/targets.py", 0,
                "sim_dense", "dtype drift"),
    ]
    docs = {"R001": RULE_DOCS["R001"], "J002": RULE_DOCS["J002"]}
    doc = to_sarif(findings, docs, "/repo")
    assert doc["version"] == SARIF_VERSION
    (run_,) = doc["runs"]
    assert run_["tool"]["driver"]["name"] == "swarmlint"
    assert [r["id"] for r in run_["tool"]["driver"]["rules"]] == \
        ["J002", "R001"]
    assert run_["originalUriBaseIds"]["SRCROOT"]["uri"] == "file:///repo/"
    r1, r2 = run_["results"]
    assert r1["ruleId"] == "R001"
    loc = r1["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "src/repro_torch/a.py"
    assert loc["artifactLocation"]["uriBaseId"] == "SRCROOT"
    assert loc["region"]["startLine"] == 12
    # program-level findings (line 0) pin to SARIF's 1-based minimum
    assert r2["locations"][0]["physicalLocation"]["region"]["startLine"] == 1
    assert "[sim_dense]" in r2["message"]["text"]


def test_sarif_clean_run_still_declares_rules():
    doc = to_sarif([], {rid: RULE_DOCS[rid] for rid in OPS_RULE_IDS},
                   "/repo")
    run_ = doc["runs"][0]
    assert run_["results"] == []
    assert len(run_["tool"]["driver"]["rules"]) == len(OPS_RULE_IDS)


def test_sarif_cli_emits_valid_json():
    res = _cli("--root", fixture("r001_tn"), "--tier", "ast", "--format",
               "sarif", "--no-baseline")
    assert res.returncode == 0, res.stderr
    doc = json.loads(res.stdout)
    assert doc["version"] == SARIF_VERSION
    assert doc["runs"][0]["tool"]["driver"]["name"] == "swarmlint"


# ---------------------------------------------------------------------------
# baseline pruning (--prune-baseline)
# ---------------------------------------------------------------------------

_BASELINE_TEXT = """\
# keep this comment
[[allow]]
rule = "R001"
file = "src/repro_torch/live.py"
symbol = "f:key"
reason = "still fires"

[[allow]]
rule = "J001"
file = "src/repro_torch/dead.py"
symbol = "gone"
reason = "the finding was fixed"

[[digest_exempt]]
field = "label"
reason = "presentation only"
"""


def test_prune_baseline_text_drops_only_dead_entries_of_run_rules():
    live = {("R001", "src/repro_torch/live.py", "f:key")}
    new, dropped = prune_baseline_text(_BASELINE_TEXT, live,
                                       ["R001", "J001"])
    assert dropped == [("J001", "src/repro_torch/dead.py", "gone")]
    bl = parse_baseline(new)
    assert bl.allows_ == (("R001", "src/repro_torch/live.py", "f:key"),)
    assert bl.digest_exempt == {"label": "presentation only"}
    assert "# keep this comment" in new


def test_prune_baseline_text_keeps_entries_of_rules_not_run():
    """A dead J001 entry cannot be proven dead by an ast-only run."""
    new, dropped = prune_baseline_text(_BASELINE_TEXT, set(), ["R001"])
    assert dropped == [("R001", "src/repro_torch/live.py", "f:key")]
    bl = parse_baseline(new)
    assert ("J001", "src/repro_torch/dead.py", "gone") in bl.allows_


def test_prune_baseline_cli_roundtrip(tmp_path):
    """``--prune-baseline`` rewrites analysis_baseline_torch.toml in place
    and reports drops; run against a copy of a fixture tree."""
    root = tmp_path / "repo"
    shutil.copytree(fixture("r001_tn"), root)
    (root / BASELINE_NAME).write_text(_BASELINE_TEXT)
    (root / "analysis_baseline.toml").write_text("# the reference's\n")
    res = _cli("--root", str(root), "--tier", "ast", "--prune-baseline")
    assert res.returncode == 0, res.stderr
    assert "pruned dead baseline entry: R001" in res.stdout
    bl = parse_baseline((root / BASELINE_NAME).read_text())
    # the J001 entry survived: its rule did not run under --tier ast
    assert bl.allows_ == (("J001", "src/repro_torch/dead.py", "gone"),)
    # the reference's baseline is never touched
    assert (root / "analysis_baseline.toml").read_text() == \
        "# the reference's\n"


# ---------------------------------------------------------------------------
# CLI contract: exit codes, JSON shape, tiers
# ---------------------------------------------------------------------------


def test_cli_clean_tree_exits_zero():
    p = _cli("--root", REPO, "--tier", "ast")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 finding(s)" in p.stdout and "baselined" in p.stdout


def test_cli_no_baseline_reports_the_ast_entries():
    p = _cli("--root", REPO, "--tier", "ast", "--no-baseline", "--format",
             "json")
    assert p.returncode == 1
    doc = json.loads(p.stdout)
    got = {(f["rule"], f["file"], f["symbol"]) for f in doc["findings"]}
    bl = load_baseline(REPO)
    assert {a for a in bl.allows_ if a[0] in RULES} <= got


@pytest.mark.parametrize("fix,rule", [("r001_tp", "R001"),
                                      ("r002_tp", "R002"),
                                      ("r003_tp", "R003"),
                                      ("r004_tp", "R004")])
def test_cli_true_positive_exits_nonzero(fix, rule):
    p = _cli("--root", fixture(fix), "--rules", rule, "--format", "json")
    assert p.returncode == 1, p.stdout + p.stderr
    doc = json.loads(p.stdout)
    assert doc["rules"] == [rule] and doc["tier"] == "ast"
    assert doc["findings"], "expected at least one finding"
    assert all(set(f) >= {"rule", "file", "line", "symbol", "message"}
               for f in doc["findings"])


def test_cli_unknown_rule_exits_two():
    p = _cli("--rules", "R999")
    assert p.returncode == 2


def test_cli_rules_infer_their_tier():
    res = _cli("--root", fixture("r001_tn"), "--rules", "R001",
               "--no-baseline")
    assert res.returncode == 0, res.stderr
    assert "swarmlint[ast]" in res.stdout


def test_cli_rejects_rules_outside_explicit_tier():
    res = _cli("--root", fixture("r001_tn"), "--rules", "J001", "--tier",
               "ast")
    assert res.returncode == 2
    assert "tier" in res.stderr


def test_cli_rejects_unknown_rules():
    res = _cli("--root", fixture("r001_tn"), "--rules", "J999")
    assert res.returncode == 2
    assert "unknown rules" in res.stderr


def test_cli_list_rules_covers_both_tiers():
    res = _cli("--list-rules")
    assert res.returncode == 0
    for rid in OPS_RULE_IDS:
        assert f"{rid}  [ops]" in res.stdout
    for rid in RULES:
        assert f"{rid}  [ast]" in res.stdout
    assert len(res.stdout.splitlines()) == len(ALL_RULE_IDS)


def test_cli_ops_tier_needs_cuda_by_default():
    """Like every port entry point, the ops tier runs on the card unless
    asked for the CPU: without CUDA it is a configuration error (2), and
    ``run`` raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    res = _cli("--root", fixture("r001_tn"), "--tier", "ops")
    assert res.returncode == 2
    assert "CUDA" in res.stderr
    with pytest.raises(RuntimeError, match="CUDA"):
        run(fixture("r001_tn"), rules=["J004"], tier="ops")
