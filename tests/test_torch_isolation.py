"""Import isolation of the port: in a fresh interpreter that refuses to
import ``jax`` and ``repro`` (a ``sys.meta_path`` finder), every module
of ``repro_torch`` and ``chip_smoke.py`` (as a module: its work runs
under ``__main__``) import, and neither blocked package is loaded."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, importlib.util, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "repro")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print(len(names))
"""

NEW_MODULES = ("repro_torch.data.synthetic", "repro_torch.data.partition",
               "repro_torch.data.pipeline", "repro_torch.fed.async_engine",
               "repro_torch.fed.controller", "repro_torch.fed.cutplan",
               "repro_torch.checkpoint.checkpoint",
               "repro_torch.distributed.fault", "repro_torch.launch.train",
               "repro_torch.models.moe", "repro_torch.configs.xlstm_1_3b",
               "repro_torch.configs.qwen3_moe_30b_a3b",
               "repro_torch.configs.kimi_k2_1t_a32b",
               "repro_torch.configs.qwen2_vl_2b",
               "repro_torch.configs.seamless_m4t_medium",
               "repro_torch.distributed.sharding",
               "repro_torch.distributed.collectives",
               "repro_torch.distributed.mesh", "repro_torch.launch.mesh",
               "repro_torch.distributed.tensor_parallel",
               "repro_torch.configs.base", "repro_torch.kernels.records",
               "repro_torch.launch.costs", "repro_torch.launch.roofline",
               "repro_torch.launch.dryrun", "repro_torch.launch.sweep",
               "repro_torch.launch.report")


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 40


def test_walk_covers_the_new_modules():
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert set(NEW_MODULES) <= names
