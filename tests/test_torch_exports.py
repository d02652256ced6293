"""The port's public surface against the reference's.

* ``repro_torch.memory`` and ``repro_torch.models`` export the names
  ``repro.memory`` and ``repro.models`` export, each bound to the port's
  own object in the submodule the reference's comes from.
* Both packages import in a fresh interpreter whichever module comes first
  (the plan store and the models sit in import cycles), and leave no module
  of ``repro`` or ``jax`` behind.
* Every public top-level name of every module of ``src/repro`` has a twin
  under the same module path of ``src/repro_torch``, a twin under another
  name (``RENAMED``), or a reason it has none (``NO_TWIN``, mirrored in
  ROADMAP.md). The diff reads source files with ``ast`` and imports no
  module of either package.
* The twins this surface gained behave as the reference's names do.
"""

import ast
import importlib
import json
import os
import pathlib
import subprocess
import sys
import typing

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# reference module -> its twin's path, where the file was renamed
RENAMED_MODULES = {"serving/jax_backend.py": "serving/torch_backend.py"}

# (reference module, name) -> the twin's name in the twin module
RENAMED = {
    ("serving/jax_backend.py", "JaxBackend"): "TorchBackend",
    ("models/attention.py", "flash_attention_jnp"): "flash_attention_chunked",
}

# (reference module, name) -> why the port has no twin
NO_TWIN = {
    ("kernels/_compat.py", "CompilerParams"):
        "Pallas's compiler-params class; the CUDA kernels take nvcc flags (kernels/_build.py)",
    ("distributed/mesh_compat.py", "AxisType"):
        "jax mesh-API version shim; torch.distributed meshes have no axis types",
    ("distributed/mesh_compat.py", "HAS_NEW_MESH_API"):
        "jax 0.4 vs >=0.6 switch; torch.distributed has one API",
    ("distributed/mesh_compat.py", "make_mesh"):
        "jax.make_mesh shim; the port builds a Mesh with launch.mesh.make_mesh",
    ("distributed/mesh_compat.py", "set_mesh"):
        "jax's ambient-mesh context; the port threads its Mesh explicitly (ParallelCtx)",
    ("distributed/mesh_compat.py", "shard_map"):
        "jax.shard_map shim; each torch rank runs its own shard, collectives in mesh_compat",
    ("distributed/sharding.py", "to_shardings"):
        "builds jax NamedShardings; the port shards by PartitionSpec on its Mesh",
    ("distributed/sharding.py", "param_shardings"):
        "builds jax NamedShardings; the port shards by PartitionSpec on its Mesh",
    ("launch/specs.py", "SDS"):
        "jax.ShapeDtypeStruct; the port's abstract values are meta tensors",
    ("launch/roofline.py", "HloCostModel"):
        "counts an XLA HLO module; the port counts FLOPs on the meta device",
    ("launch/roofline.py", "Computation"):
        "HloCostModel's parse of an HLO computation",
    ("launch/roofline.py", "Op"):
        "HloCostModel's parse of an HLO instruction",
    ("launch/roofline.py", "COLLECTIVES"):
        "HLO collective opcodes; the port logs collectives by kind in mesh_compat",
    ("launch/roofline.py", "shape_bytes"):
        "parses an HLO shape string",
    ("launch/roofline.py", "shape_dims"):
        "parses an HLO shape string",
    ("launch/roofline.py", "ICI_BW"):
        "the TPU interconnect's rate; the port's are NVLINK_BW and NET_BW",
    ("models/common.py", "split_keys"):
        "splits a JAX PRNG key; the port draws from one torch.Generator",
    ("models/common.py", "stacked_init"):
        "vmaps an initializer over JAX layer keys; the port draws from one torch.Generator",
}


# -- the AST name diff -----------------------------------------------------------


def _all_list(tree):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            try:
                return list(ast.literal_eval(node.value))
            except ValueError:
                return None
    return None


def _bound(body, imports: bool) -> set:
    """Names a module body binds at top level (inside if/try too)."""
    out = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                out.update(e.id for e in elts if isinstance(e, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.If):
            out |= _bound(node.body + node.orelse, imports)
        elif isinstance(node, ast.Try):
            handlers = [s for h in node.handlers for s in h.body]
            out |= _bound(node.body + handlers + node.orelse + node.finalbody, imports)
    return out


def _public(path: pathlib.Path) -> set:
    """A module's public names: its ``__all__``, else what it defines at top
    level without a leading underscore (a package's ``__init__`` also counts
    what it imports: its re-exports)."""
    tree = ast.parse(path.read_text())
    names = _all_list(tree)
    if names is not None:
        return set(names)
    bound = _bound(tree.body, imports=path.name == "__init__.py")
    return {n for n in bound if not n.startswith("_")}


def _twin(rel: str) -> pathlib.Path:
    return PORT / RENAMED_MODULES.get(rel, rel)


REF_MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_has_a_twin_or_a_reason(rel):
    public = _public(REF / rel)
    twin = _twin(rel)
    have = _bound(ast.parse(twin.read_text()).body, imports=True) if twin.exists() else set()
    missing = []
    for name in sorted(public):
        if (rel, name) in NO_TWIN:
            continue
        if name not in have and RENAMED.get((rel, name)) not in have:
            missing.append(name)
    assert not missing, f"{rel}: no twin in {twin.relative_to(ROOT)} and no reason: {missing}"


def test_the_reasons_and_renames_name_real_gaps():
    """Every listed name is public in the reference and bound in no twin
    (a twin that lands takes it off the list); every renamed twin exists."""
    for (rel, name), reason in NO_TWIN.items():
        assert reason and name in _public(REF / rel), (rel, name)
        twin = _twin(rel)
        if twin.exists():
            assert name not in _bound(ast.parse(twin.read_text()).body, imports=True), (rel, name)
    for (rel, name), twin_name in RENAMED.items():
        assert name in _public(REF / rel), (rel, name)
        assert twin_name in _bound(ast.parse(_twin(rel).read_text()).body, imports=True)


def test_the_name_diff_finds_a_gap(tmp_path):
    """A public name without a twin fails the diff; a twin bound by an
    import, a private name, and a name outside ``__all__`` do not."""
    ref, twin = tmp_path / "ref.py", tmp_path / "twin.py"
    ref.write_text("import os\nA = 1\n_B = 2\ndef f(): pass\nclass C: pass\n"
                   "if os.sep:\n    D = 3\n")
    twin.write_text("from x import A\ndef f(): pass\n")
    have = _bound(ast.parse(twin.read_text()).body, imports=True)
    assert sorted(_public(ref) - have) == ["C", "D"]
    ref.write_text(ref.read_text() + "__all__ = ['A', 'f']\n")
    assert _public(ref) - have == set()


# -- package exports -------------------------------------------------------------


def _reexports(init: pathlib.Path) -> dict:
    """name -> the submodule a package ``__init__`` imports it from."""
    out = {}
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                out[a.asname or a.name] = node.module
    return out


MEMORY = _reexports(REF / "memory" / "__init__.py")
MODELS = _reexports(REF / "models" / "__init__.py")


def test_memory_all_equals_the_references():
    import repro.memory as jmem
    import repro_torch.memory as tmem

    assert tmem.__all__ == jmem.__all__
    assert len(tmem.__all__) == 26 and set(tmem.__all__) == set(MEMORY)
    assert _reexports(PORT / "memory" / "__init__.py") == {
        n: m.replace("repro.", "repro_torch.", 1) for n, m in MEMORY.items()}


@pytest.mark.parametrize("name", sorted(MEMORY))
def test_memory_export_is_the_ports_own_object(name):
    import repro_torch.memory as tmem

    sub = importlib.import_module(MEMORY[name].replace("repro.", "repro_torch.", 1))
    obj = getattr(tmem, name)
    assert obj is getattr(sub, name)
    mod = getattr(obj, "__module__", None)
    assert mod is None or mod.startswith("repro_torch."), mod


def test_models_exports_equal_the_references():
    import repro.models as jmodels
    import repro_torch.models as tmodels

    assert sorted(MODELS) == ["ParallelCtx", "abstract_cache", "abstract_params",
                              "decode_step", "forward", "init_cache", "init_params",
                              "prefill"]
    assert set(MODELS) == set(_reexports(PORT / "models" / "__init__.py"))
    for name in MODELS:
        assert hasattr(jmodels, name) and hasattr(tmodels, name)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_export_is_the_ports_own_object(name):
    import repro_torch.models as tmodels
    from repro_torch.models import lm, parallel

    obj = getattr(tmodels, name)
    assert obj is getattr(lm, name)
    assert obj.__module__.startswith("repro_torch.models.")
    if name == "ParallelCtx":
        assert obj is parallel.ParallelCtx


# -- import orders in a fresh interpreter ----------------------------------------

ORDERS = [
    ("repro_torch.core.cache", "repro_torch.memory"),
    ("repro_torch.memory", "repro_torch.core.cache"),
    ("repro_torch.memory.tiered", "repro_torch.memory"),
    ("repro_torch.core.methods", "repro_torch.memory"),
    ("repro_torch.models", "repro_torch.serving.kv_cache"),
    ("repro_torch.serving.kv_cache", "repro_torch.models"),
    ("repro_torch.kernels.ops", "repro_torch.models"),
    ("repro_torch.models.common", "repro_torch.models"),
]

PROBE = r"""
import importlib, json, sys
for m in sys.argv[1:]:
    importlib.import_module(m)
import repro_torch.memory as mem, repro_torch.models as models
assert len(mem.__all__) == 26 and models.ParallelCtx.__module__ == "repro_torch.models.parallel"
print(json.dumps(sorted(n for n in sys.modules if n.split(".")[0] in ("repro", "jax", "jaxlib"))))
"""


@pytest.mark.parametrize("order", ORDERS, ids=["-then-".join(o) for o in ORDERS])
def test_import_order_in_a_fresh_interpreter(order):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", PROBE, *order], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# -- the new twins behave as the reference's names -------------------------------


@pytest.mark.parametrize("module", ["flash_attention", "decode_attention", "paged_attention"])
def test_neg_inf_equals_the_references(module):
    jmod = importlib.import_module(f"repro.kernels.{module}")
    tmod = importlib.import_module(f"repro_torch.kernels.{module}")
    assert tmod.NEG_INF == jmod.NEG_INF == -1e30


def test_batch_is_a_dict_of_tensors():
    from repro_torch.models import lm

    assert typing.get_origin(lm.Batch) is dict
    assert typing.get_args(lm.Batch) == (str, torch.Tensor)


def test_mamba_init_wrap_draws_as_mamba_init():
    from repro_torch.configs import registry
    from repro_torch.models import lm, mamba

    cfg = registry.get_smoke("zamba2-2.7b")
    a = lm.mamba_init_wrap(cfg, torch.Generator().manual_seed(3), "cpu")
    b = mamba.mamba_init(cfg, torch.Generator().manual_seed(3), "cpu")
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _scan_inputs(rng, kind, B=2, S=13, H=3, N=8, Ns=6):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if kind == "wkv6":
        w_log = -np.exp(f(B, S, H, N) * 0.5).astype(np.float32)
        return (f(B, S, H, N), f(B, S, H, N), f(B, S, H, N), w_log, f(H, N)), f(B, H, N, N)
    dt = np.log1p(np.exp(f(B, S, H))).astype(np.float32) * 0.3
    return (f(B, S, H, N), dt, f(H) * 0.3, f(B, S, Ns), f(B, S, Ns), f(H)), f(B, H, N, Ns)


@pytest.mark.parametrize("kind,chunk", [("wkv6", 4), ("wkv6", 64), ("ssd", 5), ("ssd", 128)])
def test_chunked_scans_match_the_references_from_a_state(kind, chunk):
    """``models.rwkv.wkv6_chunked`` / ``models.mamba.ssd_chunked`` against
    the reference's functions of the same name, from a nonzero ``state0``,
    over a ragged tail: y and state within 1e-4 (fp32 both)."""
    import jax.numpy as jnp

    if kind == "wkv6":
        from repro.models.rwkv import wkv6_chunked as jfn
        from repro_torch.models.rwkv import wkv6_chunked as tfn
    else:
        from repro.models.mamba import ssd_chunked as jfn
        from repro_torch.models.mamba import ssd_chunked as tfn
    args, state0 = _scan_inputs(np.random.default_rng(7), kind)
    yj, sj = jfn(*(jnp.asarray(a) for a in args), jnp.asarray(state0), chunk=chunk)
    yt, st = tfn(*(torch.from_numpy(a) for a in args), torch.from_numpy(state0), chunk=chunk)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4, atol=1e-4)
