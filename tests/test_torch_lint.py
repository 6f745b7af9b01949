"""The port's lint (``repro_torch.lint``) held to ``repro.lint``'s
self-tests: one true positive and one true negative per rule, waiver
mechanics (RL000) and their isolation from ``repro``'s, the construction
-time hash guard against ``repro``'s (same exception, same field), the
flagged-config audits, the full audit on the CPU, and the CLI."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.lint import (AST_RULES, AUDIT_CHECKS, NOT_PORTED, Report,
                              UnhashableFieldError, check_hashable_fields,
                              default_paths, lint_paths, lint_source,
                              rule_ids)
from repro_torch.lint.catalog import ALL_IDS

REPO = Path(__file__).resolve().parents[1]
ENGINE = REPO / "src" / "repro_torch" / "serve" / "engine.py"
ENGINE_REL = "src/repro_torch/serve/engine.py"


def ids(findings, *, include_waived=False):
    return sorted(f.rule_id for f in findings
                  if include_waived or not f.waived)


def run(src, relpath="src/repro_torch/train/somefile.py"):
    return lint_source(textwrap.dedent(src), relpath)


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO / "src")}


# ---------------------------------------------------------------------------
# catalog sanity
# ---------------------------------------------------------------------------

def test_catalog_covers_registered_rules():
    assert set(rule_ids()) == {r.id for r in AST_RULES} - {"RL000"}
    assert len(set(ALL_IDS)) == len(ALL_IDS)
    assert all(r.invariant and r.established
               for r in AST_RULES + AUDIT_CHECKS + NOT_PORTED)
    # repro's Pallas rules stand apart with their reason, unregistered
    assert {r.id for r in NOT_PORTED} == {"RL005", "RL006"}
    assert not {r.id for r in NOT_PORTED} & set(ALL_IDS)
    assert all("CUDA C++" in r.invariant for r in NOT_PORTED)


# ---------------------------------------------------------------------------
# RL000 — waiver mechanics
# ---------------------------------------------------------------------------

RL000_CASES = {
    "no_reason": ('''
        import torch
        def f(x):
            # reprolint-torch: disable=RL001
            return torch.median(x, dim=0)
        ''', ["RL000", "RL001"], ["RL000", "RL001"]),
    "reasoned": ('''
        import torch
        def f(x):
            # reprolint-torch: disable=RL001 oracle for the dispatch test
            return torch.median(x, dim=0)
        ''', [], ["RL001"]),
    "stale": ('''
        # reprolint-torch: disable=RL002 there is nothing repeated here
        x = 1
        ''', ["RL000"], ["RL000"]),
    "docstring": ("""
        def f():
            '''Docs may say `# reprolint-torch: disable=RL001` freely.'''
            return 0
        """, [], []),
}


@pytest.mark.parametrize("case", list(RL000_CASES))
def test_rl000_waiver_mechanics(case):
    src, active, every = RL000_CASES[case]
    fs = run(src)
    assert ids(fs) == active
    assert ids(fs, include_waived=True) == every


def test_waivers_are_isolated_from_repro_both_ways():
    """``repro``'s lint neither takes the port's waiver nor calls it stale;
    the port's neither takes ``repro``'s nor calls it stale."""
    from repro.lint import lint_source as repro_lint

    port_waived = textwrap.dedent('''
        import jax.numpy as jnp
        import torch
        def f(x):
            # reprolint-torch: disable=RL001 oracle under test
            return torch.median(x, dim=0) + jnp.median(x, axis=0)
        ''')
    rel = "tests/test_x.py"
    assert ids(repro_lint(port_waived, rel)) == ["RL001"]   # jnp, unwaived
    assert ids(repro_lint(port_waived, rel), include_waived=True) == [
        "RL001"]                                           # no stale RL000
    assert ids(lint_source(port_waived, rel)) == []
    assert ids(lint_source(port_waived, rel), include_waived=True) == [
        "RL001"]

    repro_waived = port_waived.replace("reprolint-torch:", "reprolint:")
    assert ids(repro_lint(repro_waived, rel)) == []
    assert ids(lint_source(repro_waived, rel)) == ["RL001"]  # torch, active
    assert ids(lint_source(repro_waived, rel), include_waived=True) == [
        "RL001"]                                             # no stale


# ---------------------------------------------------------------------------
# RL001 — direct-aggregation-bypass
# ---------------------------------------------------------------------------

def test_rl001_true_positive_torch_method_and_aggregators():
    fs = run("""
        import torch
        from repro_torch.core import aggregators
        def f(x):
            a = torch.median(x, dim=0).values + torch.nanquantile(x, 0.5)
            b = x.quantile(0.5, dim=0) + x.median(dim=0).values
            return a + b + aggregators.trimmed_mean(x, 0.1)
        """)
    assert ids(fs).count("RL001") == 6


def test_rl001_true_negative_estimator_layer_and_host():
    src = """
        import torch
        def f(x):
            return torch.median(x, dim=0).values
        """
    for rel in ("src/repro_torch/core/estimator.py",
                "src/repro_torch/core/adaptive.py",
                "src/repro_torch/kernels/ref.py"):
        assert ids(lint_source(textwrap.dedent(src), rel)) == []
    fs = run("""
        import statistics
        import numpy as np
        def f(x, xs):
            return np.median(x, axis=0) + statistics.median(xs)
        """)
    assert ids(fs) == []


def test_rl001_robust_reduce_routes_through_the_estimator_layer():
    """The chunked wire's census goes through ``core.adaptive``
    (``census_of_blocks``): ``dist/robust_reduce.py`` no longer reaches
    into ``core.aggregators``, which ``repro``'s counterpart never does."""
    rel = "src/repro_torch/dist/robust_reduce.py"
    src = (REPO / rel).read_text()
    assert ids(lint_source(src, rel), include_waived=True) == []
    from repro_torch.core import adaptive as AD

    assert callable(AD.census_of_blocks)


# ---------------------------------------------------------------------------
# RL002 — kv-head-repeat
# ---------------------------------------------------------------------------

def test_rl002_true_positive_kv_repeat_in_models():
    fs = lint_source(textwrap.dedent("""
        import torch
        def mha(q, k, v, cache, G):
            k = torch.repeat_interleave(k, G, dim=2)
            v = v.repeat_interleave(G, dim=2)
            kk = cache.k.repeat(1, 1, G, 1)
            vv = v[:, :, :, None].expand(-1, -1, -1, G, -1).reshape(q.shape)
            return q
        """), "src/repro_torch/models/myattn.py")
    assert ids(fs) == ["RL002"] * 4


def test_rl002_true_negative_ssm_groups_and_other_dirs():
    # mamba2's state-group expansion: not a K/V name
    src = (REPO / "src/repro_torch/models/mamba2.py").read_text()
    assert "B.repeat_interleave" in src
    assert ids(lint_source(src, "src/repro_torch/models/mamba2.py")) == []
    fs = lint_source(textwrap.dedent("""
        def f(k, tok, m):
            return k.repeat_interleave(4, dim=2), tok.repeat(m)
        """), "src/repro_torch/serve/engine2.py")
    assert ids(fs) == []


# ---------------------------------------------------------------------------
# RL003 — nothing in a captured step reads the host
# ---------------------------------------------------------------------------

def test_rl003_true_positive_in_a_captured_step():
    fs = run("""
        import torch

        class Eng:
            def _step(self, buf, n: int):
                if buf.t > 0:                  # a tensor in an if
                    pass
                k = int(buf.t)                 # a host read by cast
                v = buf.out.sum().item()       # a host read
                w = torch.tensor([1.0], device="cuda")   # host -> device
                return self._inner(buf.tok)

            def _inner(self, tok):
                return tok.tolist()            # followed: a host read

            def capture(self, buf, g):
                with torch.cuda.graph(g):
                    self._step(buf, 3)
        """)
    assert ids(fs) == ["RL003"] * 5
    assert {f.line for f in fs} == {6, 8, 9, 10, 14}


def test_rl003_true_negative_static_reads_and_outside_the_capture():
    fs = run("""
        import torch
        from typing import NamedTuple

        class Sampling(NamedTuple):
            method: str = "greedy"

        def tail(logits, sc: Sampling, steps: int, bias=None):
            if sc.method == "greedy" and steps > 1:
                return torch.argmax(logits, dim=-1)
            if bias is not None and logits.shape[0] > 1:
                return logits + bias
            n = int(logits.size(0)) + len(logits.shape) + logits.dim()
            return logits.float() * n

        def drain(buf):
            vals = buf.diag.tolist()           # outside the capture
            return [int(c) for c in vals]

        def capture(g, logits, sc: Sampling):
            with torch.cuda.graph(g):
                tail(logits, sc, 2)
            return drain(logits)
        """)
    assert ids(fs) == []


def _engine(src=None):
    """The engine's findings, its imports followed (``path``)."""
    src = ENGINE.read_text() if src is None else src
    return lint_source(src, ENGINE_REL, path=str(ENGINE))


def test_rl003_the_engine_is_clean_and_its_drain_is_not_flagged():
    """The real decode step (``_step`` -> ``_decode_step`` ->
    ``sample_tokens`` -> ``categorical``, and across modules
    ``robust.robust_sample``, ``obs.diag.serve_diag``) is clean but for
    one waived type dispatch; ``_drain_diag``'s ``.tolist()``, outside
    the capture, is not flagged."""
    src = ENGINE.read_text()
    assert "vals = buf.diag.tolist()" in src
    fs = _engine(src)
    assert ids(fs) == []
    assert [(f.rule_id, f.waived) for f in fs] == [("RL003", True)]
    assert "obs/diag.py" in fs[0].message
    # without the file on disk the rule stays in the file: the waiver
    # then matches nothing
    assert ids(lint_source(src, ENGINE_REL)) == ["RL000"]


def test_rl003_follows_imports_into_other_modules(tmp_path):
    """A host read two modules away from the capture is reported at the
    capturing file's call that leads there, naming the far line."""
    pkg = tmp_path / "pkgx"
    (pkg / "sub").mkdir(parents=True)
    for d in (pkg, pkg / "sub"):
        (d / "__init__.py").write_text("")
    (pkg / "sub" / "deep.py").write_text(textwrap.dedent("""
        def leaf(t):
            return t.sum().item()
        """))
    (pkg / "mid.py").write_text(textwrap.dedent("""
        from .sub.deep import leaf

        def middle(x, n: int):
            if n > 1:
                return leaf(x)
            return x
        """))
    cap = pkg / "cap.py"
    cap.write_text(textwrap.dedent("""
        import torch

        from . import mid as MID

        def capture(g, x):
            with torch.cuda.graph(g):
                MID.middle(x, 2)
        """))
    fs = lint_paths([str(cap)], str(tmp_path))
    assert ids(fs) == ["RL003"]
    assert fs[0].line == 8 and "pkgx/sub/deep.py:3" in fs[0].message
    assert "pkgx.sub.deep.leaf" in fs[0].message


def test_rl003_flags_a_host_read_planted_in_sample_tokens():
    """``test_cuda_capture_of_a_host_read_raises`` plants ``int(tok[0])``
    in ``sample_tokens`` and the card's capture refuses it; the rule flags
    the same plant before any card time."""
    src = ENGINE.read_text()
    old = ('    if sc.method == "greedy":\n'
           '        return torch.argmax(logits, dim=-1).to(torch.int32)\n')
    assert old in src
    bad = src.replace(old, (
        '    if sc.method == "greedy":\n'
        '        tok = torch.argmax(logits, dim=-1).to(torch.int32)\n'
        '        int(tok[0])  # a device value read on the host\n'
        '        return tok\n'))
    fs = _engine(bad)
    assert ids(fs) == ["RL003"]
    line = bad.splitlines().index(
        '        int(tok[0])  # a device value read on the host') + 1
    assert fs[0].line == line and "sample_tokens" in fs[0].message
    # the same read in _drain_diag (never captured) is not flagged
    drained = src.replace("        vals = buf.diag.tolist()\n",
                          "        vals = buf.diag.tolist()\n"
                          "        int(buf.tok[0])\n")
    assert drained != src
    assert ids(_engine(drained)) == []


# ---------------------------------------------------------------------------
# RL004 — unhashable-static
# ---------------------------------------------------------------------------

def test_rl004_true_positive_unfrozen_and_mutable_field():
    fs = run("""
        import dataclasses
        from typing import List, NamedTuple
        import torch

        @dataclasses.dataclass
        class DecodeConfig:
            m: int = 8

        class TileSpec(NamedTuple):
            dims: List[int]
            table: torch.Tensor
        """)
    assert ids(fs) == ["RL004"] * 3


def test_rl004_true_negative_frozen_config_and_host_record():
    fs = run("""
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class DecodeConfig:
            m: int = 8
            name: str = "x"

        @dataclasses.dataclass
        class DecodeBuffers:   # device buffers: not config-named
            tok: object = None
        """)
    assert ids(fs) == []


# ---------------------------------------------------------------------------
# RL007 — wall-clock-outside-obs
# ---------------------------------------------------------------------------

def test_rl007_true_positive_clock_call_and_import():
    fs = run("""
        import time
        from time import perf_counter

        def f():
            t0 = time.time()
            t1 = perf_counter()
            return time.monotonic() - t0 + t1
        """)
    assert ids(fs) == ["RL007"] * 3


def test_rl007_true_negative_now_and_nonclock_time():
    fs = lint_source(textwrap.dedent("""
        import time

        def now():
            return time.perf_counter()
        """), "src/repro_torch/obs/metrics.py")
    assert ids(fs) == []
    # only now() is the allowed site, not the rest of the obs layer
    fs = lint_source(textwrap.dedent("""
        import time

        def elapsed():
            return time.perf_counter()
        """), "src/repro_torch/obs/metrics.py")
    assert ids(fs) == ["RL007"]
    fs = run("""
        import time

        def f():
            time.sleep(0.1)
            return time.strftime("%Y")
        """)
    assert ids(fs) == []


@pytest.mark.parametrize("relpath", ["chip_smoke.py", "scripts/kernel_ab.py",
                                     "tests/test_torch_obs.py",
                                     "src/repro/serve/scheduler.py"])
def test_rl007_scope_is_the_port_library_only(relpath):
    src = textwrap.dedent("""
        import time

        def f():
            return time.time()
        """)
    assert ids(lint_source(src, relpath)) == []
    assert ids(lint_source(src, "src/repro_torch/serve/scheduler.py")) == [
        "RL007"]


def test_rl007_port_library_tree_is_clean():
    findings = [f for f in lint_paths([str(REPO / "src" / "repro_torch")],
                                      root=str(REPO))
                if f.rule_id == "RL007" and not f.waived]
    assert findings == [], findings


# ---------------------------------------------------------------------------
# the hash guard, against repro's
# ---------------------------------------------------------------------------

def _arch(mod, **kw):
    return mod.ArchConfig(name="x", family="dense", n_layers=1, d_model=8,
                          n_heads=2, n_kv_heads=1, d_ff=16, vocab=32, **kw)


HASH_CASES = {
    "Estimator": ("core.estimator",
                  lambda m: m.Estimator(method="median", K=[1, 2]),
                  r"Estimator\.K"),
    "RobustDecodeConfig": ("serve.robust",
                           lambda m: m.RobustDecodeConfig(
                               m=8, attack=["gaussian"]),
                           r"RobustDecodeConfig\.attack"),
    "ArchConfig": ("configs.base",
                   lambda m: _arch(m, source=["paper"]),
                   r"ArchConfig\.source"),
    "FaultPlan": ("dist.faults", lambda m: m.FaultPlan(dropout=[0.1]),
                  r"FaultPlan\.dropout"),
}


@pytest.mark.parametrize("spec", list(HASH_CASES))
def test_hash_guard_matches_repro(spec):
    """Each spec raises ``UnhashableFieldError`` (a ``TypeError``) naming
    the same field in both packages."""
    import importlib

    from repro.lint.hashguard import UnhashableFieldError as JUnhashable

    mod, make, field = HASH_CASES[spec]
    with pytest.raises(JUnhashable, match=field) as jerr:
        make(importlib.import_module(f"repro.{mod}"))
    with pytest.raises(UnhashableFieldError, match=field) as terr:
        make(importlib.import_module(f"repro_torch.{mod}"))
    assert isinstance(terr.value, TypeError)
    head = str(jerr.value).split(" is unhashable")[0]
    assert str(terr.value).split(" is unhashable")[0] == head


def test_hash_guard_keeps_clean_specs_and_replace():
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.estimator import Estimator
    from repro_torch.dist.faults import FaultPlan
    from repro_torch.serve.robust import RobustDecodeConfig

    est = Estimator(method="median")
    assert est._replace(K=3).K == 3 and hash(est._replace(K=3))
    hash(RobustDecodeConfig(m=8, estimator="median"))
    hash(FaultPlan(dropout=0.1)._replace(n_crashed=1))
    hash(_arch(sys.modules[ArchConfig.__module__]))


def test_check_hashable_fields_plain_object():
    class Box:
        def __init__(self):
            self.data = {"a": 1}

    with pytest.raises(UnhashableFieldError, match=r"Box\.data"):
        check_hashable_fields(Box())


# ---------------------------------------------------------------------------
# auditor: flagged configs and the full run
# ---------------------------------------------------------------------------

def test_auditor_flags_worker_indivisible_config():
    from repro_torch.lint.auditor import divisibility_audit

    bad = divisibility_audit("train.global_batch", batch=9, n_workers=8)
    assert bad.status == "fail" and "not divisible" in bad.detail
    good = divisibility_audit("train.global_batch", batch=16, n_workers=8)
    assert good.status == "ok" and good.check_id == "RL205"


def test_auditor_flags_hash_unstable_config():
    import dataclasses

    from repro_torch.core.estimator import Estimator
    from repro_torch.lint.auditor import capture_stability
    from repro_torch.serve.engine import Sampling

    @dataclasses.dataclass(frozen=True, eq=False)  # hash by identity
    class DriftyConfig:
        m: int = 8

    bad = capture_stability("DriftyConfig", DriftyConfig)
    assert bad.status == "fail"
    for name, fac in (("Estimator", lambda: Estimator(method="median")),
                      ("Sampling", lambda: Sampling("top_k", 0.7, 5))):
        good = capture_stability(name, fac)
        assert good.status == "ok", good.detail


def test_auditor_flags_consensus_validity_region():
    from repro_torch.lint.auditor import consensus_validity_audit

    bad = consensus_validity_audit("dist.consensus", n=8, f=2)
    assert bad.status == "fail" and "n > 5f" in bad.detail
    boundary = consensus_validity_audit("dist.consensus", n=10, f=2)
    assert boundary.status == "fail"  # n == 5f is still invalid
    good = consensus_validity_audit("dist.consensus", n=8, f=1)
    assert good.status == "ok", good.detail
    assert good.check_id == "RL210"


def test_auditor_full_run_on_the_cpu_has_no_failures():
    from repro_torch.lint import run_audit

    results = run_audit(device="cpu")
    fails = [r for r in results if r.status == "fail"]
    assert not fails, "\n".join(r.render() for r in fails)
    assert [r.check_id for r in results if r.status == "skip"] == ["RL201"]
    assert {c.id for c in AUDIT_CHECKS} <= {r.check_id for r in results}
    assert all(r.seconds >= 0.0 for r in results)


def test_auditor_catches_a_wide_symmetric_wire(monkeypatch):
    """RL202 fails when the whole ``[W, p·p]`` square rides the wire."""
    import torch

    import repro_torch.dist.robust_reduce as RR
    from repro_torch.lint import auditor as A

    def square(mats, est="vrmom"):
        W, p = mats.shape[0], mats.shape[-1]
        out = est.apply(mats.reshape(W, p * p).float(), axis=0)
        return out.reshape(p, p).to(mats.dtype)

    monkeypatch.setattr(RR, "aggregate_symmetric_stacked", square)
    (res,) = A._check_symmetric_wire(torch.device("cpu"))
    assert res.status == "fail" and "p(p+1)/2" in res.detail


def test_run_audit_without_a_card_raises(monkeypatch):
    import torch

    from repro_torch.lint import run_audit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_audit()


# ---------------------------------------------------------------------------
# the shipped tree, the CLI, and the AST layer without torch
# ---------------------------------------------------------------------------

def test_shipped_port_tree_is_lint_clean():
    findings = lint_paths(default_paths(str(REPO)), str(REPO))
    report = Report(findings=findings, audit=[])
    assert report.errors == [], report.render_text()
    assert all(f.waive_reason for f in findings if f.waived)


def test_walker_lints_the_dist_package():
    """``repro``'s walker skips every directory named ``dist``; the port's
    skips it only when it is not a Python package."""
    from repro_torch.lint import iter_py_files

    files = iter_py_files([str(REPO / "src" / "repro_torch")], str(REPO))
    assert str(REPO / "src" / "repro_torch" / "dist" / "faults.py") in files


def _cli(*args, cwd=REPO):
    return subprocess.run([sys.executable, "-m", "repro_torch.lint", *args],
                          capture_output=True, text=True, env=_env(),
                          cwd=str(cwd), timeout=300)


@pytest.mark.parametrize("kind", ["RL001", "RL003"])
def test_cli_exits_nonzero_on_violation(tmp_path, kind):
    bad = tmp_path / "bad.py"
    if kind == "RL001":
        bad.write_text("import torch\n"
                       "def f(x):\n"
                       "    return torch.median(x, dim=0)\n")
    else:
        bad.write_text("import torch\n"
                       "def step(x):\n"
                       "    return x * x.max().item()\n"
                       "def capture(g, x):\n"
                       "    with torch.cuda.graph(g):\n"
                       "        step(x)\n")
    proc = _cli(str(bad), "--format", "json", cwd=tmp_path)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert f'"{kind}"' in proc.stdout
    proc = _cli(str(bad), "--warn-only", cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "1 warning" in proc.stdout


def test_cli_default_tree_and_cpu_audit_exit_zero(tmp_path):
    out = tmp_path / "lint.json"
    proc = _cli("--audit", "--device", "cpu", "--out", str(out),
                cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 error(s)" in proc.stdout and "0 fail / 1 skip" in proc.stdout
    import json

    doc = json.loads(out.read_text())
    assert "src/repro_torch" in doc["paths"]
    assert doc["summary"]["audit_fail"] == 0


def test_ast_layer_imports_without_torch_jax_or_repro():
    code = textwrap.dedent(f"""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("torch", "jax", "repro"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        from repro_torch.lint import lint_paths, Report
        from repro_torch.lint import __main__ as cli
        fs = lint_paths([{str(ENGINE)!r}], {str(REPO)!r})
        assert Report(fs, []).errors == [], fs
        assert not any(m.split(".")[0] in ("torch", "jax", "repro")
                       for m in sys.modules)
        print("ok")
        """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"
