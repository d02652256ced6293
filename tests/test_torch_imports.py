"""The port's standing rule as a check: every module of ``repro_torch``, and
``chip_smoke.py``'s top level, import with ``jax`` and the reference package
``repro`` unavailable (the machine with the GPU has no jax)."""

import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

PROBE = r"""
import importlib, json, pkgutil, sys

REFUSED = ("jax", "jaxlib", "repro")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
mods = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for m in mods:
    importlib.import_module(m)
import chip_smoke
leaked = sorted(n for n in sys.modules if n.split(".")[0] in REFUSED)
print(json.dumps({"modules": mods, "leaked": leaked}))
"""


def test_port_and_chip_smoke_import_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    mods = set(got["modules"])
    for m in ("repro_torch.kernels.paged_attention", "repro_torch.serving.kv_cache",
              "repro_torch.serving.router", "repro_torch.serving.engine",
              "repro_torch.index.device", "repro_torch.launch.serve",
              "repro_torch.models.rwkv", "repro_torch.models.mamba",
              "repro_torch.kernels.rwkv6", "repro_torch.kernels.ssd",
              "repro_torch.envs.workloads", "repro_torch.core.deep_research",
              "repro_torch.core.harness", "repro_torch.memory.registry",
              "repro_torch.index.bucketed", "repro_torch.obs", "repro_torch.obs.__main__",
              "repro_torch.obs.names", "repro_torch.obs.registry", "repro_torch.obs.spans",
              "repro_torch.obs.attribution", "repro_torch.obs.exporters",
              "repro_torch.core.journal", "repro_torch.core.speculative",
              "repro_torch.core.distributed_cache", "repro_torch.serving.scheduler",
              "repro_torch.models.moe", "repro_torch.configs.granite_moe_1b_a400m",
              "repro_torch.configs.kimi_k2_1t_a32b", "repro_torch.configs.qwen3_4b",
              "repro_torch.configs.qwen2_vl_7b", "repro_torch.configs.whisper_tiny",
              "repro_torch.checkpoint.store", "repro_torch.memory.tiered",
              "repro_torch.core.fuzzy", "repro_torch.training.optimizer",
              "repro_torch.training.grad_compress", "repro_torch.training.train_step",
              "repro_torch.distributed.fault", "repro_torch.launch.train",
              "repro_torch.distributed.mesh_compat", "repro_torch.distributed.sharding",
              "repro_torch.distributed.pipeline", "repro_torch.distributed.elastic",
              "repro_torch.launch.mesh", "repro_torch.launch.specs",
              "repro_torch.models.parallel"):
        assert m in mods
