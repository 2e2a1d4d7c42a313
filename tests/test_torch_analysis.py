"""The port's parity-lint against the reference's.

``repro_torch.analysis`` is ``repro.analysis`` module for module. Where a
rule is unchanged (rng's numpy/stdlib draws and seeds, ordering, protocol,
suppressions, baseline and reports), the two linters must report the same
``(rule, line, col, severity)`` on tests/test_analysis.py's fixture
snippets and trees. The four retargeted rules (``device_sync`` and
``f64`` on ``core/engine_torch/`` and torch's calls, ``pickle_safety`` on
the port's mirror caches, ``rng`` on torch's global generator) get torch
fixtures that trigger them and ones that pass. Then the CLI's exit codes,
and the meta tests: ``src/repro_torch`` is clean against the package's
baseline, and a host sync added to ``free_run``'s generation loop is
caught.
"""
import json
import textwrap
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
from repro.analysis.baseline import baseline_dict as ref_baseline_dict
from repro.analysis.report import to_json as ref_to_json
from repro.analysis.report import to_text as ref_to_text
from repro_torch import cli
from repro_torch.analysis import (ERROR, UNUSED_SUPPRESSION, WARNING,
                                  default_rules, lint_paths, run_source)
from repro_torch.analysis.baseline import Baseline, baseline_dict
from repro_torch.analysis.report import to_json, to_text

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
BASELINE = PORT / "analysis" / "parity-lint-baseline.json"
ENGINE = "core/engine_torch/fast.py"


def lint(src: str, path: str = "core/module.py"):
    return run_source(textwrap.dedent(src), path)


def rule_names(findings):
    return [f.rule for f in findings]


def keyed(findings):
    return [(f.rule, f.line, f.col, f.severity) for f in findings]


# ------------------------------------------- shared fixtures, both linters
# (snippet, module path) of tests/test_analysis.py for the rules the port
# keeps unchanged
SHARED = {
    # rng
    "np_module_draw": ("np.random.shuffle(order)\n", "core/module.py"),
    "py_module_draw": ("x = random.randint(0, 7)\n", "core/module.py"),
    "seeded_constructors": ("""
        rng = np.random.default_rng(seed)
        g = np.random.Generator(np.random.Philox(key=seed))
        r = random.Random(seed * 3 + 1)
        x = rng.random()
    """, "core/module.py"),
    "rng_scope_outside_core": ("np.random.shuffle(order)\n",
                               "training/optimizer.py"),
    "time_seed": ("rng = random.Random(time.time())\n", "serving/engine.py"),
    "unseeded_constructor": ("rng = np.random.default_rng()\n", "hub/x.py"),
    "seed_method_from_clock": ("rng.seed(int(time.time_ns()))\n",
                               "data/x.py"),
    "draw_in_set_loop": ("""
        for key in set(pending):
            order.append(rng.random())
    """, "core/module.py"),
    "draw_in_set_comprehension": (
        "picks = [rng.choice(vals) for v in {1, 2, 3}]\n", "core/module.py"),
    "sorted_set_loop_draw": ("""
        for key in sorted(set(pending)):
            order.append(rng.random())
    """, "core/module.py"),
    "draw_over_list": ("""
        for key in pending_list:
            order.append(rng.random())
    """, "core/module.py"),
    # protocol
    "runner_call_in_strategy": ("""
        def _optimize(self, space, runner, rng):
            return runner.run_batch(configs)
    """, "core/strategies/fast_sa.py"),
    "runner_call_outside_strategies": (
        "obs = self.runner.run_batch(configs)\n", "core/driver.py"),
    "runner_attr_read": ("best = runner.best\n",
                         "core/strategies/fast_sa.py"),
    "state_retention": ("""
        class _FastState(SearchState):
            def attach_runner(self, runner):
                self.runner = runner
    """, "core/module.py"),
    "state_retention_underscore": ("""
        class _FastState(SearchState):
            def attach_runner(self, runner):
                self._runner = runner
    """, "core/module.py"),
    "bind_and_init": ("""
        class _FastState(SearchState):
            def __init__(self, space, rng):
                self.space = space
            def bind(self, space):
                self.space = space
    """, "core/module.py"),
    # ordering
    "unsorted_listdir": ("""
        for name in os.listdir(root):
            shards.append(name)
    """, "launch/serve.py"),
    "sorted_listdir": ("""
        for name in sorted(os.listdir(root)):
            shards.append(name)
    """, "launch/serve.py"),
    "unsorted_path_glob": ("paths = list(root.glob('*.jsonl'))\n",
                           "core/module.py"),
    "set_loop_in_core": ("""
        for key in {"a", "b"}:
            journal.append(key)
    """, "core/module.py"),
    "set_loop_outside_core": ("""
        for key in {"a", "b"}:
            journal.append(key)
    """, "models/mlp.py"),
    "sorted_set_loop": ("""
        for key in sorted({"a", "b"}):
            journal.append(key)
    """, "core/module.py"),
    "import_time_environ_assign": ("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    """, "launch/dryrun.py"),
    "import_time_environ_setdefault": ("""
        import os
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    """, "models/mlp.py"),
    "env_mutation_inside_function": ("""
        import os
        def main():
            os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
            os.environ.setdefault("JAX_PLATFORMS", "cpu")
    """, "launch/dryrun.py"),
    "import_time_environ_read": ("""
        import os
        FAST = os.environ.get("REPRO_FAST") == "1"
    """, "core/module.py"),
    # suppressions and the framework's own findings
    "inline_disable": ("np.random.shuffle(x)"
                       "  # parity-lint: disable=rng-module-draw\n",
                       "core/module.py"),
    "disable_all": ("np.random.shuffle(x)  # parity-lint: disable=all\n",
                    "core/module.py"),
    "disable_other_rule": ("np.random.shuffle(x)"
                           "  # parity-lint: disable=ordering-listdir\n",
                           "core/module.py"),
    "unused_suppression": ("x = 1  # parity-lint: disable=rng-module-draw\n",
                           "core/module.py"),
    "unused_not_self_suppressible": (
        "x = 1  # parity-lint: disable=unused-suppression\n",
        "core/module.py"),
    "syntax_error": ("def broken(:\n", "core/module.py"),
    "plain_attrs": ("""
        class Columns:
            def __init__(self):
                self.time_s = []
    """, "core/module.py"),
}
# the trigger cases above: each must report something on both sides
TRIGGERS = {"np_module_draw", "py_module_draw", "time_seed",
            "unseeded_constructor", "seed_method_from_clock",
            "draw_in_set_loop", "draw_in_set_comprehension",
            "runner_call_in_strategy", "state_retention",
            "unsorted_listdir", "unsorted_path_glob", "set_loop_in_core",
            "import_time_environ_assign", "import_time_environ_setdefault",
            "disable_other_rule", "unused_suppression",
            "unused_not_self_suppressible", "syntax_error"}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_fixture_matches_reference(case):
    src, path = SHARED[case]
    src = textwrap.dedent(src)
    mine = keyed(run_source(src, path))
    assert mine == keyed(ref_analysis.run_source(src, path))
    assert bool(mine) == (case in TRIGGERS)


def test_rule_catalogue_matches_reference():
    mine = {(r.name, r.severity) for r in default_rules()}
    ref = {(r.name, r.severity) for r in ref_analysis.default_rules()}
    assert mine == ref
    shared = {"rng-time-seed", "rng-set-iteration", "protocol-runner-call",
              "protocol-state-retention", "ordering-listdir",
              "ordering-set-iteration", "ordering-import-env-mutation"}
    mine_scope = {r.name: r.scope for r in default_rules()}
    ref_scope = {r.name: r.scope for r in ref_analysis.default_rules()}
    assert all(mine_scope[n] == ref_scope[n] for n in shared)


# ---------------------------------- baseline and reports, both linters
def _tree(tmp_path, source="np.random.shuffle(x)\n"):
    tree = tmp_path / "core"
    tree.mkdir()
    (tree / "mod.py").write_text(source)
    return tmp_path


def _both(paths, baseline=None):
    return (lint_paths(paths, baseline=baseline),
            ref_analysis.lint_paths(paths, baseline=baseline))


def _same_result(mine, ref):
    assert keyed(mine.findings) == keyed(ref.findings)
    assert keyed(mine.baselined) == keyed(ref.baselined)
    assert mine.stale_baseline == ref.stale_baseline
    assert mine.n_files == ref.n_files


@pytest.mark.parametrize("case", ["finding", "clean", "baselined", "stale",
                                  "count_limited"])
def test_baseline_matches_reference(tmp_path, case):
    src = {"clean": "x = 1\n", "count_limited":
           "np.random.shuffle(x)\nnp.random.shuffle(x)\n"}.get(
               case, "np.random.shuffle(x)\n")
    root = _tree(tmp_path, src)
    bpath = None
    if case in ("baselined", "count_limited"):
        res = lint_paths([str(root)])
        data = baseline_dict(res.findings[:1],
                             lambda f: "np.random.shuffle(x)")
        assert data == ref_baseline_dict(res.findings[:1],
                                         lambda f: "np.random.shuffle(x)")
        bpath = tmp_path / "baseline.json"
        bpath.write_text(json.dumps(data))
    elif case == "stale":
        bpath = tmp_path / "baseline.json"
        bpath.write_text(json.dumps(
            {"format": "parity-lint-baseline", "version": 1,
             "entries": [{"rule": "rng-module-draw", "path": "core/mod.py",
                          "context": "np.random.shuffle(y)"}]}))
    mine, ref = _both([str(root)], None if bpath is None else str(bpath))
    _same_result(mine, ref)
    assert to_text(mine) == ref_to_text(ref)
    expect = {"finding": (1, 0, 0), "clean": (0, 0, 0),
              "baselined": (0, 1, 0), "stale": (1, 0, 1),
              "count_limited": (1, 1, 0)}[case]
    assert (len(mine.findings), len(mine.baselined),
            len(mine.stale_baseline)) == expect


def test_baseline_is_count_limited():
    findings = lint("np.random.shuffle(x)\nnp.random.shuffle(x)\n")
    bl = Baseline(baseline_dict(findings[:1],
                                lambda f: "np.random.shuffle(x)")["entries"])
    survivors = [f for f in findings
                 if not bl.match(f, "np.random.shuffle(x)")]
    assert len(survivors) == 1  # the second duplicate still gates


def test_malformed_baseline_is_value_error(tmp_path):
    bad = tmp_path / "baseline.json"
    bad.write_text("{not json")
    with pytest.raises(ValueError):
        lint_paths([str(tmp_path)], baseline=str(bad))


def test_json_report_matches_reference(tmp_path):
    root = _tree(tmp_path)
    rules, ref_rules = default_rules(), ref_analysis.default_rules()
    mine = to_json(lint_paths([str(root)], rules=rules), rules)
    ref = ref_to_json(ref_analysis.lint_paths([str(root)], rules=ref_rules),
                      ref_rules)
    assert mine.keys() == ref.keys()
    for k in mine:
        if k != "rules":
            assert mine[k] == ref[k], k
    assert [r["rule"] for r in mine["rules"]] == \
        [r["rule"] for r in ref["rules"]]
    assert mine["format"] == "parity-lint-report" and mine["n_errors"] == 1
    json.dumps(mine)


# ------------------------------------------------- device_sync, retargeted
class TestDeviceSync:
    def test_item_in_loop_over_device_value_triggers(self):
        out = lint("""
            def drain(rows, n):
                out = torch.zeros(n, dtype=torch.float64)
                total = 0.0
                for i in range(n):
                    total += out[i].item()
                return total
        """, ENGINE)
        assert rule_names(out) == ["device-sync-in-loop"]
        assert out[0].severity == ERROR

    @pytest.mark.parametrize("conv", ["float(out[i])", "int(out[i])",
                                      "out[i].tolist()", "out[i].cpu()",
                                      "out.numpy()", "np.asarray(out[i])"])
    def test_each_conversion_triggers(self, conv):
        out = lint(f"""
            def drain(rows, n):
                out = budget_scan(rows)
                for i in range(n):
                    consume({conv})
        """, ENGINE)
        assert rule_names(out) == ["device-sync-in-loop"]

    def test_to_and_cuda_make_device_values(self):
        out = lint("""
            def drain(x, n):
                a = x.to(dev)
                b = x.cuda()
                return [a[i].item() + b[i].item() for i in range(n)]
        """, ENGINE)
        assert rule_names(out) == ["device-sync-in-loop"] * 2

    def test_batched_output_idiom_passes(self):
        # launch and the one bulk conversion in the same loop iteration
        assert lint("""
            def drive(runs):
                while runs:
                    out = budget_scan(segment(runs))
                    accept = out[0].cpu().numpy()
                    runs = survivors(runs, accept)
        """, ENGINE) == []

    def test_loop_carried_device_value_triggers(self):
        # spent is the loop's device state: assigned before the loop and
        # again in it; converting it syncs every generation
        out = lint("""
            def run(G, rows):
                spent = torch.zeros(4, dtype=torch.float64)
                for gen in range(G):
                    spent = budget_scan(rows, spent)[4]
                    if float(spent.max()) > 1.0:
                        break
        """, ENGINE)
        assert rule_names(out) == ["device-sync-in-loop"]

    def test_conversion_result_is_host(self):
        assert lint("""
            def commit(rows, runs):
                out = budget_scan(rows)
                spent = out[4].cpu().numpy()
                for i, run in enumerate(runs):
                    run.spent = float(spent[i])
        """, ENGINE) == []

    def test_bulk_conversion_after_loop_passes(self):
        assert lint("""
            def run(G, rows):
                spent = torch.zeros(4, dtype=torch.float64)
                for gen in range(G):
                    spent = budget_scan(rows, spent)[4]
                return spent.cpu().numpy()
        """, ENGINE) == []

    def test_host_numpy_tolist_passes(self):
        # replay.py's commit: .tolist() of host arrays syncs nothing
        assert lint("""
            def commit(out, rows, acc_idx):
                value = out["value"][0]
                for r in rows.tolist():
                    use(value[acc_idx].tolist())
        """, ENGINE) == []

    def test_scope_outside_engine_passes(self):
        assert lint("""
            def drain(rows, n):
                out = torch.zeros(n)
                return [out[i].item() for i in range(n)]
        """, "core/methodology.py") == []


# --------------------------------------------------------- f64, retargeted
class TestF64:
    def test_torch_cumsum_triggers(self):
        out = lint("t = torch.cumsum(charges, 0)\n", ENGINE)
        assert rule_names(out) == ["f64-parallel-scan"]
        assert out[0].severity == ERROR

    def test_np_cumsum_passes(self):
        assert lint("t = np.cumsum(charges)\n", ENGINE) == []

    def test_cumsum_outside_engine_passes(self):
        assert lint("t = torch.cumsum(charges, 0)\n",
                    "core/methodology.py") == []

    @pytest.mark.parametrize("src", ["total = torch.sum(spent)\n",
                                     "total = spent.sum()\n",
                                     "n = accept.sum(dim=1)\n"])
    def test_sum_without_dtype_warns(self, src):
        out = lint(src, ENGINE)
        assert rule_names(out) == ["f64-sum-dtype"]
        assert out[0].severity == WARNING

    def test_sum_with_dtype_passes(self):
        assert lint("""
            total = torch.sum(spent, dtype=torch.float64)
            n = accept.sum(dim=1, dtype=torch.int64)
        """, ENGINE) == []

    def test_float32_triggers(self):
        out = lint("""
            a = torch.zeros(4, dtype=torch.float32)
            b = charges.to(torch.float)
            c = charges.float()
            d = np.zeros(4, dtype="float32")
        """, ENGINE)
        assert rule_names(out) == ["f64-float32-literal"] * 4

    def test_float64_and_int32_pass(self):
        assert lint("""
            a = torch.zeros(4, dtype=torch.float64)
            b = rows.to(torch.int32)
            c = float(x)
        """, ENGINE) == []

    def test_old_scope_is_not_the_port(self):
        # the reference's engine_jax scope has no counterpart in the port
        assert lint("t = torch.cumsum(charges, 0)\n",
                    "core/engine_jax/fast.py") == []


# ----------------------------------------------- pickle_safety, retargeted
class TestPickle:
    def test_device_memo_without_getstate_triggers(self):
        out = lint("""
            class Columns:
                def __init__(self):
                    self._device = None
        """, "serving/engine.py")
        assert rule_names(out) == ["pickle-device-cache"]

    def test_torch_engine_in_slots_triggers(self):
        out = lint("""
            class Runner:
                __slots__ = ("budget", "_torch_eng")
        """)
        assert rule_names(out) == ["pickle-device-cache"]

    def test_device_memo_with_getstate_passes(self):
        assert lint("""
            class Columns:
                def __init__(self):
                    self._device = None
                def __getstate__(self):
                    return {k: v for k, v in self.__dict__.items()
                            if k != "_device"}
        """) == []

    def test_state_torch_attr_triggers(self):
        out = lint("""
            class _FastState(SearchState):
                def tell(self, observations):
                    self.pop = torch.zeros((8, 4))
        """)
        assert rule_names(out) == ["pickle-state-device-attr"]

    def test_state_numpy_and_underscore_attrs_pass(self):
        assert lint("""
            class _FastState(SearchState):
                def tell(self, observations):
                    self.pop = np.zeros((8, 4))
                    self._scratch = torch.zeros((8, 4))
        """) == []

    def test_reference_jax_memo_is_not_the_port(self):
        src = textwrap.dedent("""
            class Columns:
                def __init__(self):
                    self._jax = None
        """)
        assert run_source(src, "serving/engine.py") == []
        assert rule_names(ref_analysis.run_source(src, "serving/engine.py")) \
            == ["pickle-device-cache"]


# ------------------------------------------------------- rng, retargeted
class TestTorchRng:
    @pytest.mark.parametrize("src", [
        "x = torch.rand(3)\n", "x = torch.randint(0, 7, (4,))\n",
        "p = torch.randperm(10)\n", "i = torch.multinomial(w, 4, True)\n",
        "x = torch.empty(3).uniform_()\n", "x.normal_(0.0, 1.0)\n",
        "torch.manual_seed(0)\n"])
    def test_global_generator_triggers(self, src):
        out = lint(src)
        assert rule_names(out) == ["rng-module-draw"]
        assert out[0].severity == ERROR

    def test_explicit_generator_passes(self):
        assert lint("""
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            x = torch.rand(3, generator=g)
            y = torch.empty(3).uniform_(generator=g)
            i = torch.randint(0, 7, (4,), generator=g)
        """) == []

    def test_scope_outside_core_passes(self):
        assert lint("x = torch.rand(3)\n", "models/layers.py") == []

    def test_generator_seeded_from_clock_triggers(self):
        out = lint("g.manual_seed(int(time.time()))\n", "models/layers.py")
        assert rule_names(out) == ["rng-time-seed"]


# ------------------------------------------------------------------- CLI
class TestCli:
    def test_lint_clean_exit_zero(self, tmp_path, capsys):
        root = _tree(tmp_path, "x = 1\n")
        assert cli.main(["lint", str(root), "--no-baseline"]) == 0
        assert "clean" in capsys.readouterr().out

    def test_lint_findings_exit_one(self, tmp_path, capsys):
        root = _tree(tmp_path)
        assert cli.main(["lint", str(root), "--no-baseline"]) == 1
        assert "rng-module-draw" in capsys.readouterr().out

    def test_lint_missing_path_one_line_error(self):
        with pytest.raises(SystemExit) as exc:
            cli.main(["lint", "/no/such/tree"])
        assert "no such path" in str(exc.value.code)

    def test_lint_json_format(self, tmp_path, capsys):
        root = _tree(tmp_path)
        assert cli.main(["lint", str(root), "--no-baseline",
                         "--format", "json"]) == 1
        assert json.loads(capsys.readouterr().out)["n_errors"] == 1

    def test_lint_report_artifact(self, tmp_path):
        root = _tree(tmp_path)
        report = tmp_path / "lint-report.json"
        cli.main(["lint", str(root), "--no-baseline",
                  "--report", str(report)])
        assert json.loads(report.read_text())["findings"]

    def test_lint_write_baseline_roundtrip(self, tmp_path, capsys):
        root = _tree(tmp_path)
        bpath = tmp_path / "bl.json"
        assert cli.main(["lint", str(root), "--write-baseline",
                         "--baseline", str(bpath)]) == 0
        capsys.readouterr()
        assert cli.main(["lint", str(root), "--baseline", str(bpath)]) == 0
        assert "1 baselined" in capsys.readouterr().out
        assert json.loads(bpath.read_text())["entries"] == [
            {"rule": "rng-module-draw", "path": "core/mod.py",
             "context": "np.random.shuffle(x)"}]

    def test_lint_malformed_baseline_one_line(self, tmp_path):
        root = _tree(tmp_path, "x = 1\n")
        bad = tmp_path / "bl.json"
        bad.write_text("{broken")
        with pytest.raises(SystemExit) as exc:
            cli.main(["lint", str(root), "--baseline", str(bad)])
        assert str(exc.value.code).startswith("error:")

    def test_list_rules(self, capsys):
        assert cli.main(["lint", "--list-rules"]) == 0
        out = capsys.readouterr().out
        assert "device-sync-in-loop (error; scope: core/engine_torch/)" in out

    def test_default_is_the_package_and_its_baseline(self, capsys):
        assert cli.main(["lint"]) == 0
        assert "clean" in capsys.readouterr().out
        assert cli.DEFAULT_BASELINE == str(BASELINE)


# ----------------------------------------------------------------- meta
class TestLiveTree:
    def test_port_clean_modulo_baseline(self):
        res = lint_paths([str(PORT)], baseline=str(BASELINE))
        assert res.findings == [], "\n".join(
            f.format() for f in res.findings)
        assert res.n_files > 80

    def test_baseline_has_no_stale_entries(self):
        res = lint_paths([str(PORT)], baseline=str(BASELINE))
        assert res.stale_baseline == []

    def test_free_run_module_has_no_finding(self):
        res = lint_paths([str(PORT / "core" / "engine_torch")])
        assert not [f for f in res.findings + res.baselined
                    if f.path == "core/engine_torch/strategies.py"]

    @pytest.mark.parametrize("sync", ["total = float(spent.max())",
                                      "done = bool(stopped.all())",
                                      "seen_h = seen.cpu()",
                                      "n = fresh_n.tolist()"])
    def test_sync_added_to_generation_loop_is_caught(self, tmp_path, sync):
        src = (PORT / "core" / "engine_torch" / "strategies.py").read_text()
        anchor = "stopped = stopped | exh\n"
        assert src.count(anchor) == 1
        # the sync goes right after the anchor, at its indentation
        line = src[src.rindex("\n", 0, src.index(anchor)) + 1:
                   src.index(anchor) + len(anchor)]
        indent = line[:len(line) - len(line.lstrip())]
        mutant = tmp_path / "repro_torch" / "core" / "engine_torch"
        mutant.mkdir(parents=True)
        (mutant / "strategies.py").write_text(
            src.replace(line, line + f"{indent}{sync}\n"))
        res = lint_paths([str(mutant / "strategies.py")])
        assert [(f.rule, f.path) for f in res.findings] == [
            ("device-sync-in-loop", "core/engine_torch/strategies.py")]
