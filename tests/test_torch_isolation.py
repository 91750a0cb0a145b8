"""repro_torch and chip_smoke.py import neither JAX nor the JAX package.

Checked in a fresh interpreter, so that the imports this test process
already holds cannot hide one.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from repro_torch.launch.serve import build_parser
from repro_torch.launch.train import build_parser as train_parser
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad,
                  "device": build_parser().parse_args([]).device,
                  "train_device": train_parser().parse_args(
                      ["--arch", "wdl-s1"]).device}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert "repro_torch.kernels.emb_lookup" in out["modules"]
    assert "repro_torch.launch.serve" in out["modules"]
    assert "repro_torch.launch.train" in out["modules"]
    assert "repro_torch.kernels.exchange_pack" in out["modules"]
    assert "repro_torch.quant.codecs" in out["modules"]
    for name in ("kernels.auction", "core.auction", "core.simulator",
                 "core.cache", "core.baselines", "ps.partition",
                 "exchange.plan", "obs.trace", "pipeline.window",
                 "serve.sim", "device", "kernels.flash_attn",
                 "models.layers", "models.backbone", "models.api",
                 "optim.optimizers", "data.loader", "configs.base",
                 "configs.smollm_360m"):
        assert f"repro_torch.{name}" in out["modules"]
    assert out["device"] == "cuda"
    assert out["train_device"] == "cuda"


def test_sources_name_no_jax_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (f, line)
            assert not (s.startswith(("import repro", "from repro"))
                        and not s.startswith(("import repro_torch",
                                              "from repro_torch"))), (f, line)
