"""The port stands alone: ``import repro_torch`` loads no JAX, and no file
of the port (nor ``chip_smoke.py``) imports JAX or any module of the JAX
package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

# `import jax`, `from jax...`, `import repro` / `import repro.x`,
# `from repro import` / `from repro.x import` — never `repro_torch`
_JAX = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
_REPRO = re.compile(r"^\s*(import\s+repro(\s|\.|,|$)|from\s+repro(\s|\.))",
                    re.M)


def test_import_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serve.engine, "
            "repro_torch.core.compress, repro_torch.bridge, "
            "repro_torch.ckpt.store, repro_torch.core.numerics_device, "
            "repro_torch.kernels.gram, repro_torch.serve.aot, "
            "repro_torch.serve.paged, repro_torch.serve.admission, "
            "repro_torch.obs, repro_torch.dist.faultinject, "
            "repro_torch.dist.ft, repro_torch.serve.frontdoor, "
            "repro_torch.serve.api, repro_torch.launch.serve, "
            "repro_torch.pytree, repro_torch.optim.adamw, "
            "repro_torch.optim.powersgd, repro_torch.train.step, "
            "repro_torch.train.loop, repro_torch.train.lora, "
            "repro_torch.launch.train, repro_torch.dist.comm, "
            "repro_torch.dist.sharding, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.launch.op_analysis; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_import_no_jax_and_nothing_of_repro():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(SOURCES) > 20
    names = {p.relative_to(PORT).as_posix() for p in SOURCES[:-1]}
    assert {"ckpt/store.py", "core/numerics_device.py", "kernels/gram.py",
            "serve/aot.py", "serve/paged.py", "serve/admission.py",
            "obs/trace.py", "obs/metrics.py", "obs/flightrec.py",
            "dist/faultinject.py", "dist/ft.py", "serve/frontdoor.py",
            "serve/api.py", "launch/serve.py", "pytree.py",
            "optim/adamw.py", "optim/powersgd.py", "train/step.py",
            "train/loop.py", "train/lora.py", "launch/train.py",
            "dist/comm.py", "dist/sharding.py", "launch/mesh.py",
            "launch/dryrun.py", "launch/op_analysis.py"} <= names
    for path in SOURCES:
        text = path.read_text()
        assert not _JAX.search(text), f"{path} imports jax"
        assert not _REPRO.search(text), f"{path} imports the JAX package"
        assert "importlib.import_module(\"repro." not in text, path


def test_scan_patterns():
    assert _REPRO.search("from repro.models import params")
    assert _REPRO.search("import repro.core.compress as C")
    assert _REPRO.search("from repro import bridge")
    assert not _REPRO.search("from repro_torch.models import params")
    assert not _REPRO.search("import repro_torch")
    assert _JAX.search("import jax.numpy as jnp")
    assert not _JAX.search("import jaxtyping_free_module")
