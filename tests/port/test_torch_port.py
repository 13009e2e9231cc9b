"""The PyTorch port's package boundary: configs equal the JAX registry
field by field, the weight bridge round-trips exactly, entry points refuse
a missing CUDA device, and no module of the port reaches JAX or ``repro``."""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package is the reference
import torch

from repro.configs import list_configs as jax_list_configs
from repro_torch.bridge import from_jax_values, to_jax_values
from repro_torch.configs import check_supported, list_configs
from repro_torch.models import lm

from torch_port_util import free_jax_programs, jax_and_torch_model  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[2]
PORT = ROOT / "src" / "repro_torch"


def test_configs_equal_jax_for_every_arch():
    jax_cfgs = jax_list_configs()
    torch_cfgs = list_configs()
    assert sorted(torch_cfgs) == sorted(jax_cfgs)
    for name, jc in jax_cfgs.items():
        tc = torch_cfgs[name]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
        assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced()), name


def test_unported_parts_are_refused_at_build():
    cfg = list_configs()["mamba2-130m"].reduced()  # the ssd mixer
    with pytest.raises(KeyError, match="not ported"):
        check_supported(cfg)
    with pytest.raises(KeyError, match="not ported"):
        lm.init_lm(cfg, device="cpu")
    hyena = list_configs()["hyena-153m"].reduced()
    check_supported(hyena)
    for change in ({"norm": "layernorm"}, {"tie_embeddings": True}, {"moe": True}):
        with pytest.raises(NotImplementedError, match="not ported"):
            lm.init_lm(dataclasses.replace(hyena, **change), device="cpu")
    # the attention family and the four MLP kinds build now
    for arch in ("qwen2.5-14b", "qwen2-72b", "nemotron-4-15b"):
        check_supported(list_configs()[arch].reduced())
    phi4 = list_configs()["phi4-mini-3.8b"].reduced()
    check_supported(phi4)
    for mlp in ("swiglu", "geglu", "gelu", "squared_relu"):
        params = lm.init_lm(dataclasses.replace(phi4, mlp=mlp), device="cpu")
        assert ("gate" in params["blocks"][0]["mlp"]) == (mlp in ("swiglu", "geglu"))


@pytest.mark.parametrize("arch", ["hyena-153m", "hyena-125m", "phi4-mini-3.8b"])
def test_bridge_round_trip_is_exact(arch):
    _, values, tcfg, params = jax_and_torch_model(arch)
    want = jax.tree_util.tree_map(np.asarray, values)
    back = to_jax_values(params, tcfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the port's own init has the same tree and shapes as the JAX init
    own = to_jax_values(lm.init_lm(tcfg, seed=3, device="cpu"), tcfg)
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(own)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = list_configs()["hyena-153m"].reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_lm(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_caches(cfg, 1, 8)
    _, values, tcfg, _ = jax_and_torch_model("hyena-153m")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_jax_values(jax.tree_util.tree_map(np.asarray, values), tcfg)


def test_port_tests_are_collected_before_the_jax_suite(request):
    """The port's tests live in ``tests/port/`` so that pytest collects them
    before the JAX suite: it sorts a directory's entries by name, folders
    and files together, and ``port`` sorts before ``test_*.py``.  xdist
    sizes the batches it hands a worker by the tests still pending, so
    tests collected after the JAX suite would enlarge the batches of
    ``test_serve_engine.py``'s randomized harnesses; a worker that runs
    several of them keeps every XLA program it compiled mapped and can
    reach the per-process map limit and crash.  This fails if a change of
    layout or of pytest puts any JAX-suite test ahead of a port test."""
    here = pathlib.Path(__file__).resolve().parent
    kinds = []
    for item in request.session.items:
        folder = pathlib.Path(str(item.path)).resolve().parent
        if folder == here:
            kinds.append("port")
        elif folder == here.parent:
            kinds.append("jax")
    assert "port" in kinds
    if "jax" in kinds:
        assert "port" not in kinds[kinds.index("jax"):], "a JAX-suite test precedes a port test"


_IMPORT_CHECK = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro") and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""

_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|,|$)", re.M)


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK, str(ROOT / "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 33  # every module of the port
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in sources:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"
