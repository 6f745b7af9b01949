"""repro_torch guards: import boundary, device policy, kernel sources.

* No file of the port (``src/repro_torch/**``) nor ``chip_smoke.py``
  imports JAX or ``repro`` — the port keeps its own copies.
* Entry points run on the card unless the caller names a device; with no
  card they raise instead of falling back to the CPU.
* Every C entry point a wrapper binds exists in the CUDA sources, and
  every source the builder compiles exists.
* ``chip_smoke.py`` fails (and prints no result line) without a card and
  when it stands alone.
"""
import ast
import importlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get as get_arch
from repro_torch.core.rcsl import (LinearRegressionProblem, make_shards,
                                   paper_theta_star, rcsl)
from repro_torch.device import kernel_instance
from repro_torch.infer import coverage_run
from repro_torch.kernels import build
from repro_torch.models import model as M
from repro_torch.serve import ServeEngine

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in files for line, root in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_import_scan_catches_a_violation(tmp_path):
    """The scan above sees both import forms and ignores repro_torch."""
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import vrmom\n"
                 "from repro_torch import kernels\nfrom . import x\n")
    assert [r for _, r in _imported_roots(f)] == ["jax", "repro",
                                                  "repro_torch"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_device_without_a_card(no_card):
    cfg = get_arch("qwen3-1.7b").reduced()
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax({}, cfg)
    eng = ServeEngine(cfg, params, max_len=16, device="cpu")
    assert eng.device.type == "cpu"


def test_training_entry_points_need_a_device_without_a_card(no_card):
    """make_train_step, the launcher, lm_batch and opt_state_from_jax run
    on the card unless given a device; with no card they raise."""
    from repro_torch.data import lm_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.train.step import make_train_step

    cfg = get_arch("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg, 8, reduce_backend="consensus")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen3-1.7b", "--reduced",
                           "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_batch(cfg, 0, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.opt_state_from_jax({}, cfg)
    setup = make_train_step(cfg, 4, device="cpu")
    assert setup.device.type == "cpu"
    assert make_train_step(cfg, 8, reduce_backend="consensus",
                           device="cpu").device.type == "cpu"
    assert lm_batch(cfg, 0, 2, 8, device="cpu")["tokens"].device.type == \
        "cpu"


def test_paper_path_needs_a_device_without_a_card(no_card):
    """coverage_run, make_shards and paper_theta_star run on the card
    unless given a device; rcsl runs where its tensors live."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coverage_run(reps=2, batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coverage_run(reps=2, batch_size=2, reduce_backend="consensus")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_shards(0, N_per_machine=10, m_workers=3, p=2,
                    theta_star=torch.ones(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_theta_star(3)
    theta = paper_theta_star(2, device="cpu")
    sh = make_shards(0, N_per_machine=20, m_workers=4, p=2,
                     theta_star=theta, device="cpu")
    est, _ = rcsl(LinearRegressionProblem(), sh, rounds=1)
    assert est.device.type == "cpu"
    cell = coverage_run(reps=2, N_per_machine=20, m_workers=4, p=2,
                        rounds=1, batch_size=2, attack="none", alpha=0.0,
                        device="cpu")
    assert cell.covered.device.type == "cpu"
    cell = coverage_run(reps=2, N_per_machine=20, m_workers=6, p=2,
                        rounds=1, batch_size=2, attack="none", alpha=0.0,
                        reduce_backend="consensus", device="cpu")
    assert cell.covered.device.type == "cpu"


def test_adaptive_state_needs_a_device_without_a_card(no_card):
    """init_adaptive_state / init_state, the train step's init_state and
    adaptive_state_from_jax make the carry on the card unless given a
    device; with no card they raise."""
    import numpy as np

    from repro_torch.core import adaptive as AD
    from repro_torch.core.estimator import Estimator
    from repro_torch.train.step import make_train_step

    est = Estimator("vrmom_adaptive")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        est.init_adaptive_state(4, 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AD.init_state(4, 6)
    st = AD.init_state(4, 6, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.adaptive_state_from_jax(
            st._replace(**{f: np.asarray(getattr(st, f))
                           for f in st._fields}))
    assert est.init_adaptive_state(4, 6, device="cpu").momentum.device.type \
        == "cpu"
    cfg = get_arch("qwen3-1.7b").reduced()
    setup = make_train_step(cfg, 4, estimator="auto_gm", device="cpu")
    state = setup.init_state()
    assert state.weights.shape == (4,) and state.momentum.device.type == "cpu"
    assert state.momentum.numel() == M.param_count(
        M.init(cfg, torch.Generator().manual_seed(0), device="cpu"))


def test_c_entry_points_exist_in_sources():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file(), name
    for lib in build.SOURCES:
        # the package re-exports functions under the module names
        mod = importlib.import_module(f"repro_torch.kernels.{lib}")
        src = (build.CSRC / f"{lib}.cu").read_text()
        for fn, argtypes in mod._SIGNATURES.items():
            m = re.search(rf"\bint {fn}\(([^)]*)\)", src)
            assert m, f"{fn} not defined in {lib}.cu"
            n_args = len([a for a in m.group(1).split(",") if a.strip()])
            assert n_args == len(argtypes), (fn, n_args, len(argtypes))


def test_library_name_tracks_sources_and_flags(monkeypatch):
    a = build.library_path("vrmom")
    monkeypatch.setitem(build.EXTRA_FLAGS, "vrmom", ("--fmad=true",))
    assert build.library_path("vrmom") != a
    assert a.parent == REPO / "build" / "repro_torch"


def test_chip_smoke_fails_without_a_card_or_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(REPO / "chip_smoke.py", script)
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_kernel_instance_reads_both_name_forms():
    """Which instance of a kernel ran, from its device name as the profiler
    gives it, demangled or mangled."""
    demangled = ("void (anonymous namespace)::decode_split_kernel<96, 16, "
                 "__nv_bfloat16, signed char>(__nv_bfloat16 const*)")
    assert kernel_instance(demangled, "decode_split_kernel") == (96, 16)
    assert kernel_instance(
        "_ZN12_GLOBAL__N_119decode_split_kernelILi112ELi8EfaEEv",
        "decode_split_kernel") == (112, 8)
    assert kernel_instance(
        "void (anonymous namespace)::wg::flash_fwd_wgmma<96>("
        "__nv_bfloat16 const*)", "flash_fwd_wgmma") == (96,)
    assert kernel_instance(
        "_ZN12_GLOBAL__N_12wg15flash_fwd_wgmmaILi112EEEvPK",
        "flash_fwd_wgmma") == (112,)
    assert kernel_instance("tail_kernel<8>", "flash_fwd_wgmma") is None
