"""The port's static analyzer (``mpit_tpu_torch.analysis``) against the
JAX package's and against the port's own tree.

- every non-hot-path family finds what the JAX analyzer finds, finding for
  finding, on the JAX package's fixture trees read in place;
- each torch hot-path rule (MT-T3xx) fires at its seeded line and is
  silent on a clean torch tree;
- the port's tree has zero unsuppressed findings under
  ``mtlint_torch.toml``, whose every entry is justified and used;
- the declared disciplines and ``HOT_PATHS`` carry no stale row, and the
  JAX registry's rows are each re-declared or retired with a reason;
- the wire-schema registry is the reference's as plain data, renders the
  same PROTOCOL.md tables, and the model checker explores the same states;
- the entry points' exit codes;
- the findings fixed in the port's code stay fixed where it shows: the
  servers' and the supervisor's wall-clock stamps are on the obs time
  base.

The analyzer reads source only: nothing here needs a card.
"""

import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import mpit_tpu.analysis as jax_analysis
from mpit_tpu.analysis import disciplines as jax_disciplines
from mpit_tpu.analysis import modelcheck as jax_modelcheck
from mpit_tpu.analysis import schema as jax_schema
from mpit_tpu_torch import analysis
from mpit_tpu_torch.analysis import (callgraph, disciplines, modelcheck, ownership,
                                     schema, torchrules)
from mpit_tpu_torch.analysis.config import ConfigError, load_config
from mpit_tpu_torch.analysis.core import collect

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "mpit_tpu_torch"
FIXTURES = REPO / "tests" / "fixtures" / "mtlint"
BASELINE = REPO / "mtlint_torch.toml"


def _keys(findings, drop_prefix):
    return {(f.rule, f.path, f.line, f.severity) for f in findings
            if not f.rule.startswith(drop_prefix)}


@pytest.fixture(scope="module")
def port_report():
    return analysis.run(PORT, load_config(BASELINE))


# -- the JAX package's fixtures, read in place --------------------------------


@pytest.mark.parametrize("tree", ["badpkg", "cleanpkg", "driftpkg", "machines"])
def test_fixture_findings_match_the_jax_analyzer(tree):
    """Protocol, concurrency, observability, schema, disciplines and
    ownership: the same (rule, path, line, severity) set as the reference."""
    want = _keys(jax_analysis.run(FIXTURES / tree).findings, "MT-J3")
    got = _keys(analysis.run(FIXTURES / tree).findings, "MT-T3")
    assert got == want
    if tree == "badpkg":
        assert len(want) > 40


# -- the torch hot-path rules on seeded trees ---------------------------------

SEEDED = {
    "train/loop.py": """
        import torch


        def body(x, w):
            w.sub_(x.sum().item() * w)  # expect: MT-T301
            if torch.isfinite(w).all():  # expect: MT-T302
                w.mul_(2)
            return w


        def run(x, w, g):
            with torch.cuda.graph(g):
                body(x, w)
                n = float(w.norm())  # expect: MT-T301
            return n
        """,
    "train/graphed.py": """
        import torch


        def fwd(x):
            return x.tolist()  # expect: MT-T301


        def build(x):
            return torch.cuda.make_graphed_callables(fwd, (x,))
        """,
    "ops/attn.py": """
        import torch


        class _Attn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q):
                ctx.save_for_backward(q)
                return q * 2

            @staticmethod
            def backward(ctx, g):
                scale = g.abs().max().cpu()  # expect: MT-T301
                while g.sum() > 0:  # expect: MT-T302
                    g.sub_(1)
                return g * scale
        """,
    "optim/msgd.py": """
        import numpy as np


        def msgd_commit(w, g, lr):
            w.sub_(lr * g)
            np.asarray(w)  # expect: MT-T301
            return w


        def msgd_step(w, g, lr):
            w = w - lr * g  # expect: MT-T303
            return w
        """,
    "optim/rules.py": """
        import torch


        def adam_apply(p, g, state):
            p.sub_(g)
            torch.cuda.synchronize()  # expect: MT-T301
            return p, state
        """,
    "dplane/hbm.py": """
        import torch


        class HbmSlot:
            def apply_wire(self, codec, grad):
                self._write(grad.to("cpu"))  # expect: MT-T301 MT-T311

            def _write(self, g):
                self.param.add_(g)

            def push_grad(self, g):
                torch.cuda.synchronize()  # expect: MT-T312
                return g.tolist()  # expect: MT-T311
        """,
    "train/lm_launch.py": """
        def build_step(cfg):
            def train_step(w, toks):
                if (w > 0).any():  # expect: MT-T302
                    w.add_(toks)
                return w
            return train_step
        """,
    "parallel/easgd.py": """
        class MeshEASGD:
            def _sync(self, state):
                return state["w"].sum()

            def step(self, state):
                loss = self._sync(state)
                return int(loss.mean())  # expect: MT-T301
        """,
}

CLEAN = {
    "train/loop.py": """
        import torch


        def body(x, w):
            w.add_(x)


        def run(x, w, g):
            with torch.cuda.graph(g):
                body(x, w)
            return float(w.sum())
        """,
    "optim/msgd.py": """
        def msgd_commit(w, vt, g, cfg):
            fused_nesterov_commit(w, vt, g, l2wd=float(cfg.l2wd))
            if cfg.mom > 0 and w.dim() == 2:
                w.sub_(g)
            return w


        def msgd_step(w, g, lr):
            g = g + 0.1 * w
            w.sub_(lr * g)
            return w
        """,
    "optim/shells.py": """
        class Shell:
            def step(self, w):
                self.grad[:] = w.cpu().numpy()
                return w
        """,
    "optim/rules.py": """
        import torch


        def adam_apply(p, g, state):
            t = state["t"].add_(1)
            beta = 1.0 - torch.pow(0.9, t.to(p.dtype))
            if torch.is_tensor(g) and torch.cuda.is_available():
                p.sub_(beta * g)
            return p, state
        """,
    "dplane/hbm.py": """
        import numpy as np
        import torch


        def _as_tensor(x):
            if isinstance(x, torch.Tensor):
                return x
            return _from_host(x)


        def _from_host(x):
            return torch.from_numpy(np.asarray(x))


        class HbmSlot:
            def apply_wire(self, codec, grad):
                self.param.add_(_as_tensor(grad))

            def snapshot_host(self):
                return self.param.cpu().numpy()
        """,
    "dplane/exchange.py": """
        def _host(x):
            return x.detach().to("cpu").numpy()


        class ExchangeClient:
            def sync_device(self, update):
                return _host(update)
        """,
}


def _write_tree(root, files):
    expect = set()
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        body = textwrap.dedent(text).lstrip("\n")
        path.write_text(body)
        for n, line in enumerate(body.splitlines(), start=1):
            m = re.search(r"# expect: (.*)$", line)
            if m:
                expect |= {(rule, rel, n) for rule in m.group(1).split()}
    return expect


def test_torch_rules_fire_at_their_seeded_lines(tmp_path):
    expect = _write_tree(tmp_path, SEEDED)
    got = {(f.rule, f.path, f.line) for f in analysis.run(tmp_path).findings}
    assert got == expect
    assert {r for r, _p, _l in expect} == {
        "MT-T301", "MT-T302", "MT-T303", "MT-T311", "MT-T312"}


@pytest.mark.parametrize("rule,severity", [
    ("MT-T301", "error"), ("MT-T302", "warn"), ("MT-T303", "info"),
    ("MT-T311", "warn"), ("MT-T312", "warn")])
def test_torch_rules_mirror_the_jax_severities(rule, severity):
    assert analysis.RULES[rule][0] == severity
    assert jax_analysis.RULES[rule.replace("MT-T", "MT-J")][0] == severity


def test_torch_rules_are_silent_on_a_clean_tree(tmp_path):
    """``float(cfg.x)``, a wire shell's ``.cpu()`` outside HOT_PATHS, a
    host-named helper behind an isinstance guard, the device plane's
    ``_host``, host code after a capture, and metadata predicates."""
    assert _write_tree(tmp_path, CLEAN) == set()
    assert analysis.run(tmp_path).findings == []


def test_hot_set_of_the_port(tmp_path):
    """The capture in the device loop, the flash attention Function and
    every HOT_PATHS row are hot; the PS shells' wire copies are not."""
    files, errs = collect(PORT)
    assert errs == []
    graph = callgraph.build_graph(files)
    hot = {(r.src.rel, r.qual) for r in torchrules.hot_regions(graph)}
    assert ("train/mesh_launch.py", "_device_loop_train.epoch_body") in hot
    assert any(rel == "train/mesh_launch.py" and "<graph capture:" in q
               for rel, q in hot)
    assert {("ops/flash_attention.py", "_FlashAttention.forward"),
            ("ops/flash_attention.py", "_FlashAttention.backward"),
            ("parallel/easgd.py", "MeshEASGD._sync"),
            ("dplane/hbm.py", "HbmSlot._write")} <= hot
    for entry in torchrules.HOT_PATHS:
        assert any(rel.endswith(entry.file) and q == entry.qual for rel, q in hot)
    assert not {q for rel, q in hot
                if rel in ("optim/shells.py", "optim/downpour.py")
                or q in ("EAMSGD.step", "EAMSGD.start")}


def test_hot_paths_name_the_kernel_steps():
    names = {(h.file, h.qual) for h in torchrules.HOT_PATHS}
    assert {("parallel/easgd.py", "MeshEASGD.step"),   # K1
            ("optim/msgd.py", "msgd_commit"),          # K1
            ("optim/easgd.py", "elastic_step"),        # K2
            ("optim/rules.py", "adam_apply"),          # K3
            ("dplane/hbm.py", "HbmSlot.apply_wire"),   # K3
            ("train/lm_launch.py", "build_step.train_step")} <= names  # K4, K5


# -- the port's tree under its baseline ---------------------------------------


def test_port_tree_has_zero_unsuppressed_findings(port_report):
    assert port_report.findings == [], "\n" + "\n".join(
        f.render() for f in port_report.findings)


def test_baseline_entries_are_justified_and_used(port_report):
    cfg = load_config(BASELINE)
    assert cfg.suppressions
    for s in cfg.suppressions:
        assert s.reason.strip() and s.content, s.render()
        assert s.file.startswith("mpit_tpu_torch/"), s.render()
    assert port_report.unused_suppressions == [], [
        s.render() for s in port_report.unused_suppressions]
    # The five reference-shaped findings, and no torch rule among them.
    assert sorted(f.rule for f, _s in port_report.suppressed) == [
        "MT-O402", "MT-O402", "MT-O402", "MT-P201", "MT-P201"]


def test_baselines_never_meet():
    """Each package's analyzer discovers its own baseline only."""
    assert analysis.discover_config(PORT).source.name == "mtlint_torch.toml"
    assert jax_analysis.discover_config(REPO / "mpit_tpu").source.name == "mtlint.toml"
    assert jax_analysis.run(REPO / "mpit_tpu", jax_analysis.load_config(
        BASELINE)).unused_suppressions  # the port's keys match nothing there


@pytest.mark.parametrize("text,match", [
    ('[[suppress]]\nrule = "MT-T301"\nfile = "x.py"\n', "reason"),
    ('[[suppress]]\nrule = "MT-T301"\nfile = "x.py"\nreason = "  "\n', "empty reason"),
    ('[[suppress]]\nrule = "MT-T301"\nfile = "x.py"\ncontent = "xyz"\nreason = "r"\n',
     "malformed content key"),
])
def test_baseline_loader_rejects_bad_entries(tmp_path, text, match):
    bad = tmp_path / "mtlint_torch.toml"
    bad.write_text(text)
    with pytest.raises(ConfigError, match=match):
        load_config(bad)


# -- declared disciplines and HOT_PATHS ---------------------------------------


@pytest.fixture(scope="module")
def coverage():
    return disciplines.coverage_report(PORT)


def test_disciplines_and_hot_paths_verify_with_no_stale_row(coverage):
    assert coverage["stale"] == 0, [
        r["name"] for r in coverage["disciplines"] if r["status"] == "stale"]
    assert coverage["violated"] == 0, [
        r for r in coverage["disciplines"] if r["status"] == "violated"]
    kinds = {r["kind"] for r in coverage["disciplines"] if r["status"] == "verified"}
    assert kinds == {"atomic-section", "single-writer", "owned-sink", "owned-path",
                     "donated-slot", "hot-path"}
    hot = [r for r in coverage["disciplines"] if r["kind"] == "hot-path"]
    assert len(hot) == len(torchrules.HOT_PATHS)


def test_every_reference_row_is_redeclared_or_retired(coverage):
    """The JAX registry's rows: each is live in the port under its name,
    or retired with a reason beside it (and then matches no port site)."""
    live = {r["name"] for r in coverage["disciplines"] if r["status"] != "retired"}
    retired = {e.name: why for e, why in disciplines.RETIRED}
    reference = {e.name for _k, e in jax_disciplines.all_disciplines()}
    assert reference <= live | set(retired)
    assert not live & set(retired)
    assert all(len(why) > 40 for why in retired.values())
    assert set(retired) <= reference
    assert {r["name"] for r in coverage["disciplines"]
            if r["status"] == "retired"} == set(retired)
    # a retired row keeps the reference's declaration (all but its doc,
    # which the reason replaces) verbatim
    ref = {e.name: e for _k, e in jax_disciplines.all_disciplines()}
    for entry, _why in disciplines.RETIRED:
        theirs = ref[entry.name]
        assert type(entry).__name__ == type(theirs).__name__
        assert dataclasses.asdict(entry) == dict(dataclasses.asdict(theirs), doc="")


@pytest.mark.parametrize("case", ["no-sites", "retired-row-revived"])
def test_stale_declaration_gate(tmp_path, case):
    """A tree with none of the declared functions fails the gate; so does
    a tree where a retired row's shape is back (its _place_param)."""
    pkg = tmp_path / "pkg"
    if case == "no-sites":
        (pkg / "x").mkdir(parents=True)
        (pkg / "x" / "other.py").write_text("def f():\n    return 1\n")
    else:
        for rel in ("ps/server.py", "dplane/hbm.py", "optim/rules.py"):
            (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
            (pkg / rel).write_text((PORT / rel).read_text())
        src = (pkg / "ps/server.py").read_text()
        (pkg / "ps/server.py").write_text(src + textwrap.dedent("""

            def _place_param(self, arr):
                return device_copy(place_flat(arr, self._dp_cfg))
            """))
    rep = disciplines.coverage_report(pkg)
    stale = {r["name"] for r in rep["disciplines"] if r["status"] == "stale"}
    if case == "no-sites":
        assert "MeshEASGD.step" in stale and "ps-read-gate-window" in stale
    else:
        assert "ps-place-param-owned" in stale
    r = subprocess.run([sys.executable, "-m", "mpit_tpu_torch.analysis",
                        "disciplines", "--root", str(pkg)],
                       cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "stale" in r.stdout, r.stdout + r.stderr


# -- mutation proofs: breaking a seam or a hot path turns the tree red --------


def _doctored(tmp_path, rel, old, new):
    src = (PORT / rel).read_text()
    assert old in src, old
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace(old, new))
    files, errs = collect(tmp_path)
    assert errs == []
    return files


@pytest.mark.parametrize("rel,old,new,rule", [
    # the frame staging copy: without copy=True it may alias the frame
    ("ps/server.py", "torch.from_numpy(arr).to(self.device, copy=True)",
     "torch.from_numpy(arr).to(self.device)", "MT-D903"),
    # restore staging bound as the alias itself
    ("ps/server.py",
     'torch.from_numpy(np.asarray(arr, order="C")).to(self.device, copy=True)',
     'torch.from_numpy(np.asarray(arr, order="C"))', "MT-D903"),
    # seeding binds the caller's value as the slot
    ("dplane/hbm.py", "self.param.copy_(self._on_device(value).reshape(-1))",
     "self.param = self._on_device(value).reshape(-1)", "MT-D903"),
    # a snapshot that hands out the slot itself
    ("dplane/hbm.py", "pulled = self.param.clone()", "pulled = self.param",
     "MT-D902"),
])
def test_dropping_an_ownership_seam_turns_tree_red(tmp_path, rel, old, new, rule):
    files = _doctored(tmp_path, rel, old, new)
    findings = ownership.check(files)
    assert any(f.rule == rule for f in findings), [f.render() for f in findings]


@pytest.mark.parametrize("rel,old,new,rule", [
    ("parallel/easgd.py", "        self._steps += 1\n        return state, loss",
     "        self._steps += 1\n        loss.item()\n        return state, loss",
     "MT-T301"),
    ("dplane/hbm.py", "        self._write(0, self.size, codec.decode_parts(parts, self.size))",
     "        self._write(0, self.size, codec.decode_parts(parts, self.size).cpu())",
     "MT-T301"),
    ("optim/msgd.py", "    state[\"k\"].add_(1)\n    return w, state",
     "    state[\"k\"].add_(1)\n    if state[\"k\"].max() > 5:\n        pass\n"
     "    return w, state", "MT-T302"),
])
def test_a_sync_in_a_hot_path_turns_tree_red(tmp_path, rel, old, new, rule):
    files = _doctored(tmp_path, rel, old, new)
    findings = torchrules.check(files)
    assert any(f.rule == rule for f in findings), [f.render() for f in findings]


def test_ownership_lattice_knows_torch():
    src = textwrap.dedent("""
        import numpy as np
        import torch

        def f(view, arr, dev):
            a = torch.from_numpy(np.frombuffer(view, np.float32))
            b = torch.from_numpy(arr).to(dev, copy=True)
            c = [x.clone() for x in arr]
            d = c[0] if dev else c
            e = b.to(dev)
            g = torch.empty(3).copy_(a)
            return a, b, c, d, e, g
        """)
    tree = __import__("ast").parse(src)
    from mpit_tpu_torch.analysis.core import SourceFile

    sf = SourceFile(path=pathlib.Path("/x/f.py"), rel="f.py", text=src, tree=tree)
    graph = callgraph.build_graph([sf])
    (fn,) = graph.functions
    ret = fn.returns[0].elts
    states = [ownership.classify(e, fn, graph)[0] for e in ret]
    assert states == [ownership.UNOWNED, ownership.OWNED, ownership.OWNED,
                      ownership.OWNED, ownership.OWNED, ownership.OWNED]


# -- the wire schema and the model checker ------------------------------------


def _plain(x):
    if dataclasses.is_dataclass(x):
        return {k: _plain(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, dict):
        return {repr(_plain(k)): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(repr(_plain(v)) for v in x)
    if isinstance(x, re.Pattern):
        return x.pattern
    if callable(x):
        return x.__name__
    return x


def _registry_names():
    return sorted(n for n in dir(jax_schema)
                  if n.lstrip("_").isupper() and n.lstrip("_")[:1].isalpha())


@pytest.mark.parametrize("name", _registry_names())
def test_schema_registry_is_the_references_as_plain_data(name):
    assert _plain(getattr(schema, name)) == _plain(getattr(jax_schema, name))


@pytest.mark.parametrize("section", sorted(jax_schema.DOC_SECTIONS))
def test_rendered_protocol_tables_are_identical(section):
    got = schema.DOC_SECTIONS[section]()
    assert got == jax_schema.DOC_SECTIONS[section]()
    assert got in (REPO / "docs" / "PROTOCOL.md").read_text()


@pytest.mark.parametrize("machines", [None, "deadlock.py", "unreachable_ack.py",
                                      "unacked_terminal.py"])
def test_modelcheck_explores_the_references_states(machines):
    if machines is None:
        ours, ref = modelcheck.check_all(), jax_modelcheck.check_all()
    else:
        ours = modelcheck.check_all(modelcheck.load_machines_file(
            FIXTURES / "machines" / machines))
        ref = jax_modelcheck.check_all(jax_modelcheck.load_machines_file(
            FIXTURES / "machines" / machines))
    assert modelcheck.report_dict(ours) == jax_modelcheck.report_dict(ref)
    assert all(r.clean for r in ours) == (machines is None)


# -- entry points --------------------------------------------------------------


@pytest.mark.parametrize("argv,rc,needle", [
    (["tools/torch_mtlint.py", "mpit_tpu_torch"], 0, "0 finding(s), 5 suppressed"),
    (["tools/torch_mtlint.py", "tests/fixtures/mtlint/badpkg", "--quiet"], 1,
     "MT-P103"),
    (["tools/torch_mtlint.py", "no/such/path"], 2, ""),
    (["-m", "mpit_tpu_torch.analysis", "mpit_tpu_torch/"], 0, "5 suppressed"),
    (["-m", "mpit_tpu_torch.analysis", "schema", "--emit-docs", "--check"], 0,
     "schema: conformant"),
    (["-m", "mpit_tpu_torch.analysis", "modelcheck"], 0, "init-grad-stop: clean"),
    (["-m", "mpit_tpu_torch.analysis", "modelcheck", "--machines",
      "tests/fixtures/mtlint/machines/deadlock.py"], 1, "MT-M701"),
    (["-m", "mpit_tpu_torch.analysis", "disciplines"], 0, "0 stale"),
])
def test_cli_exit_codes(argv, rc, needle):
    r = subprocess.run([sys.executable, *argv], cwd=str(REPO), capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == rc, r.stdout + r.stderr
    assert needle in r.stdout


def test_bad_baseline_exits_2(tmp_path):
    bad = tmp_path / "mtlint_torch.toml"
    bad.write_text('[[suppress]]\nrule = "MT-T301"\nfile = "x.py"\n')
    r = subprocess.run([sys.executable, "tools/torch_mtlint.py", "--config", str(bad),
                        "tests/fixtures/mtlint/cleanpkg"], cwd=str(REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "bad config" in r.stderr


def test_json_output_carries_content_keys():
    r = subprocess.run([sys.executable, "tools/torch_mtlint.py", "--json",
                        "tests/fixtures/mtlint/badpkg"], cwd=str(REPO),
                       capture_output=True, text=True, timeout=120)
    data = json.loads(r.stdout)
    assert r.returncode == 1 and data["findings"]
    assert all(re.fullmatch(r"[0-9a-f]{12}", f["content"]) for f in data["findings"])


# -- the findings fixed in the code: wall stamps on the obs time base ---------

OFFSET_S = 1.7e9


@pytest.fixture
def obs_time_base(monkeypatch):
    """The obs epoch offset pinned far from the real one: a stamp on the obs
    time base is the monotonic clock plus it; a ``time.time()`` is not."""
    from mpit_tpu_torch.obs import clock

    monkeypatch.setattr(clock, "epoch_offset", lambda: OFFSET_S)
    return lambda lo, hi, stamp: lo + OFFSET_S <= stamp <= hi + OFFSET_S


def test_server_serving_and_rejoin_stamps_are_on_the_obs_time_base(obs_time_base):
    from mpit_tpu_torch.comm.local import LocalRouter
    from mpit_tpu_torch.ft import FTConfig
    from mpit_tpu_torch.ps import ParamClient, ParamServer

    router = LocalRouter(2)
    server = ParamServer(0, [1], router.endpoint(0), rule="add", device="cpu",
                         ft=FTConfig(rejoin=True))
    thread = threading.Thread(target=server.start, daemon=True)
    t0 = time.monotonic()
    thread.start()
    ft = dict(op_deadline_s=0.5, max_retries=4, backoff_base_s=0.005)
    first = ParamClient(1, [0], router.endpoint(1), seed_servers=True,
                        ft=FTConfig(**ft))
    w0 = np.ones(8, np.float32)
    first.start(w0.copy(), np.zeros_like(w0))
    deadline = time.monotonic() + 10
    while server.serving_since is None and time.monotonic() < deadline:
        time.sleep(0.005)
    assert obs_time_base(t0, time.monotonic(), server.serving_since)
    # a restarted incarnation re-announces: the rejoin is stamped too
    again = ParamClient(1, [0], router.endpoint(1), seed_servers=False,
                        ft=FTConfig(epoch=1, **ft))
    p, g = np.zeros_like(w0), np.zeros_like(w0)
    t1 = time.monotonic()
    again.start(p, g)
    while server.rejoins < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(server.rejoined_at) == 1
    assert obs_time_base(t1, time.monotonic(), server.rejoined_at[0])
    again.async_recv_param()
    again.wait()
    np.testing.assert_array_equal(p, w0)
    again.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


STUB_CHILD = """
import json, os, pathlib, sys, time

rank = int(os.environ["MPIT_RANK"])
marker = pathlib.Path(os.environ["STUB_MARKER_DIR"]) / f"rank{rank}"
if rank == 1 and not marker.exists():
    marker.touch()
    time.sleep(60)  # the chaos victim: killed here, then restarted
with open(os.environ["MPIT_RESULT_FILE"], "w") as fh:
    json.dump({"rank": rank}, fh)
"""


def test_supervisor_chaos_stamp_is_on_the_obs_time_base(tmp_path, monkeypatch,
                                                       obs_time_base):
    from mpit_tpu_torch.ft.supervisor import RestartPolicy, supervise_gang
    from mpit_tpu_torch.train import launch

    (tmp_path / "mtstubchild.py").write_text(STUB_CHILD)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    monkeypatch.setenv("STUB_MARKER_DIR", str(tmp_path))
    cfg = launch.LAUNCH_DEFAULTS.merged(dict(np=2, transport="tcp"))
    t0 = time.monotonic()
    results = supervise_gang("mtstubchild", cfg, timeout=60,
                             policy=RestartPolicy(max_restarts=1, restart_delay_s=0.0),
                             chaos_kill_rank=1, chaos_kill_after_s=1.0)
    assert [results[r]["restarts"] for r in (0, 1)] == [0, 1]
    assert obs_time_base(t0 + 1.0, time.monotonic(), results[1]["chaos_killed_at"])
    assert "chaos_killed_at" not in results[0]
