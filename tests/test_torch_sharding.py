"""The port's deployment layer against ``repro``'s, in one process: the
sharding profiles, shapes and cells of the registry, the parameter counts,
and the sharding rules (``repro_torch.distributed.sharding``) leaf by leaf
on the production meshes and a small one, over the port's own
``abstract_params`` and ``launch.specs.input_specs`` (meta tensors).

The port's layer lists carry no stacked leading axis, so a port leaf under
``blocks/<i>`` (hybrid: ``blocks/<g>/<i>``, audio: ``enc_blocks``/``dec_blocks``)
is held to the reference's stacked leaf with its leading layer entries
(always None) dropped."""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.distributed import sharding as tshd  # noqa: E402
from repro_torch.distributed.mesh_compat import AbstractMesh, P  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

KINDS = ("", "train", "prefill", "decode")
MESHES = {
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
}


class _FakeMesh:
    """The reference tests' stand-in for a jax mesh: names and a shape."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = type("D", (), {"shape": shape})()


def _meshes(name):
    shape, axes = MESHES[name]
    return _FakeMesh(shape, axes), AbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jlm.abstract_params(jreg.get(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return tlm.abstract_params(treg.get(arch))


def _ref_flat(tree):
    """{path: leaf} of a reference pytree (dict keys)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}


def _port_flat(tree, path=(), lead=0):
    """[(path without list indices, layer dims dropped, leaf)] of a port tree."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _port_flat(v, path + (k,), lead)]
    if isinstance(tree, list):
        return [x for v in tree for x in _port_flat(v, path, lead + 1)]
    return [(path, lead, tree)]


def _pairs(port_tree, ref_tree):
    """(path, port leaf, reference leaf, leading layer dims) for every port
    leaf; every reference path must be covered."""
    ref = _ref_flat(ref_tree)
    pairs = []
    for path, lead, leaf in _port_flat(port_tree):
        assert path in ref, path
        pairs.append((path, leaf, ref[path], lead))
    assert {p for p, *_ in pairs} == set(ref), sorted(set(ref) - {p for p, *_ in pairs})
    return pairs


def test_shapes_cells_and_mesh_helpers():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert treg.all_cells() == jreg.all_cells()
    for name in jbase.SHAPES:
        assert dataclasses.asdict(treg.shape(name)) == dataclasses.asdict(jreg.shape(name))
    for arch in treg.ARCH_NAMES:
        for name, shp in jbase.SHAPES.items():
            assert tbase.supports_shape(treg.get(arch), treg.shape(name)) == \
                jbase.supports_shape(jreg.get(arch), shp)
    for multi in (False, True):
        m = tmesh.make_production_mesh(multi_pod=multi)
        assert m.axis_names == (("pod", "data", "model") if multi else ("data", "model"))
        assert m.devices.shape == ((2, 16, 16) if multi else (16, 16))
    assert dataclasses.asdict(tbase.ShardingProfile()) == dataclasses.asdict(
        jbase.ShardingProfile())
    d = tbase.DeploymentConfig(model=treg.get("olmo-1b"))
    assert (d.max_decode_steps, d.microbatch, d.sharding) == (64, 0, tbase.ShardingProfile())
    assert tuple(P("data", None)) == tuple(jax.sharding.PartitionSpec("data", None))


@pytest.mark.parametrize("arch", treg.ARCH_NAMES)
def test_profiles_and_counts_match(arch):
    """Every kind's ShardingProfile, and the parameter counts."""
    for kind in KINDS:
        assert dataclasses.asdict(treg.get_sharding(arch, kind)) == dataclasses.asdict(
            jreg.get_sharding(arch, kind)), kind
    t, j = treg.get(arch), jreg.get(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.num_attn_layers == j.num_attn_layers
    assert t.supports_subquadratic_decode == j.supports_subquadratic_decode
    assert treg.get_smoke(arch).active_param_count() == jreg.get_smoke(arch).active_param_count()


@pytest.mark.parametrize("kind", ["", "train"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", treg.ARCH_NAMES)
def test_param_pspecs_match(arch, mesh, kind):
    """The port's param_pspecs over its abstract_params equal the
    reference's over its own, leaf by leaf (shapes too); every leaf is
    covered and, under the serving profile, something shards (the
    reference's test_param_pspecs_cover_tree / test_big_matrices_are_sharded,
    made a parity check)."""
    fake, am = _meshes(mesh)
    j_prof, t_prof = jreg.get_sharding(arch, kind), treg.get_sharding(arch, kind)
    jspec = jshd.param_pspecs(_ref_params(arch), j_prof, fake)
    tspec = tshd.param_pspecs(_port_params(arch), t_prof, am)
    n_sharded = 0
    for path, leaf, ref_leaf, lead in _pairs(_port_params(arch), _ref_params(arch)):
        assert tuple(leaf.shape) == tuple(ref_leaf.shape)[lead:], path
        assert leaf.device.type == "meta"
    for path, spec, ref_spec, lead in _pairs(tspec, jspec):
        assert isinstance(spec, P)
        ref_t = tuple(ref_spec)
        assert all(e is None for e in ref_t[:lead]), (path, ref_t)
        assert tuple(spec) == ref_t[lead:], (path, spec, ref_t)
        n_sharded += any(e is not None for e in spec)
    if kind == "":  # the serving profile shards something on every mesh
        assert n_sharded > 0


CELLS = [f"{a}:{s}" for a, s in jreg.all_cells()]


def _cell(cell):
    arch, shape_name = cell.split(":")
    return arch, shape_name


@pytest.mark.parametrize("cell", CELLS)
def test_input_specs_match(cell):
    """input_specs: the same leaves, shapes and dtypes as the reference's
    ShapeDtypeStructs; the cache as abstract_cache's."""
    arch, shape_name = _cell(cell)
    jb, jc = jspecs.input_specs(jreg.get(arch), jreg.shape(shape_name))
    tb, tc = tspecs.input_specs(treg.get(arch), treg.shape(shape_name))
    assert set(jb) == set(tb)
    for k in jb:
        assert tuple(tb[k].shape) == tuple(jb[k].shape), k
        assert str(tb[k].dtype).split(".")[-1] == np.dtype(jb[k].dtype).name, k
        assert tb[k].device.type == "meta"
    assert (jc is None) == (tc is None)
    if jc is not None:
        assert set(jc) == set(tc)
        for k, v in jc.items():
            if k == "length":  # the port's cache length is a Python int
                assert tc[k] == 0
                continue
            assert tuple(tc[k].shape) == tuple(v.shape), k
            assert str(tc[k].dtype).split(".")[-1] == np.dtype(v.dtype).name, k
    assert tspecs.DECODE_HEADROOM == jspecs.DECODE_HEADROOM


@pytest.mark.parametrize("mesh", ["pod2x16x16", "16x16"])
@pytest.mark.parametrize("cell", CELLS)
def test_batch_and_cache_pspecs_match(cell, mesh):
    """batch_pspecs and cache_pspecs over input_specs equal the
    reference's for the cell's profile (get_sharding(arch, kind))."""
    arch, shape_name = _cell(cell)
    fake, am = _meshes(mesh)
    kind = jreg.shape(shape_name).kind
    j_prof, t_prof = jreg.get_sharding(arch, kind), treg.get_sharding(arch, kind)
    jb, jc = jspecs.input_specs(jreg.get(arch), jreg.shape(shape_name))
    tb, tc = tspecs.input_specs(treg.get(arch), treg.shape(shape_name))
    jbs = jshd.batch_pspecs(jb, fake, j_prof)
    tbs = tshd.batch_pspecs(tb, am, t_prof)
    assert {k: tuple(v) for k, v in tbs.items()} == {k: tuple(v) for k, v in jbs.items()}
    if jc is not None:
        jcs = jshd.cache_pspecs(jc, jreg.get(arch), j_prof, fake)
        tcs = tshd.cache_pspecs(tc, treg.get(arch), t_prof, am)
        assert {k: tuple(v) for k, v in tcs.items()} == {k: tuple(v) for k, v in jcs.items()}


class _CoordMesh(AbstractMesh):
    """An abstract 2x4 mesh seen from one rank's coordinates."""

    def __init__(self, rank):
        super().__init__((2, 4), ("data", "model"))
        self.coords = tuple(int(c) for c in np.unravel_index(rank, (2, 4)))

    def axis_index(self, axes):
        idx = 0
        for a in self.axis_names:
            if a in ((axes,) if isinstance(axes, str) else axes):
                idx = idx * self.shape[a] + self.coords[self.axis_names.index(a)]
        return idx


def test_shard_tree_blocks_and_dp_axes():
    """shard_tree takes each rank's block (every coordinate of a 2x4 mesh,
    against numpy slicing; a tuple entry splits row-major over its axes);
    dp_axes_for_mesh and batch_entry as the reference's."""
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    for rank in range(8):
        d, m = np.unravel_index(rank, (2, 4))
        mesh = _CoordMesh(rank)
        want = {P("data", "model"): x[d * 4:(d + 1) * 4, m * 4:(m + 1) * 4],
                P(None, ("data", "model")): x[:, (d * 4 + m) * 2:(d * 4 + m + 1) * 2],
                P("model"): x[m * 2:(m + 1) * 2], P(): x}
        for spec, w in want.items():
            got = tshd.shard_tree({"w": [x]}, {"w": [spec]}, mesh)["w"][0]
            assert torch.equal(got, w), (rank, spec)
    for name in MESHES:
        fake, am = _meshes(name)
        for prof in (jbase.ShardingProfile(), jreg.get_sharding("olmo-1b", "train")):
            tprof = tbase.ShardingProfile(**dataclasses.asdict(prof))
            assert tshd.dp_axes_for_mesh(am, tprof) == jshd.dp_axes_for_mesh(fake, prof)
            assert tshd.batch_entry(am, tprof) == jshd.batch_entry(fake, prof)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", treg.ARCH_NAMES)
def test_concrete_batch_matches_reference_and_drives_the_model(arch, kind):
    """concrete_batch at smoke size (batch 2, 8 positions): the reference's
    leaves, shapes and dtypes, ids in [0, vocab - 1); the batch runs the
    port's loss (train) or forward (prefill) to finite values."""
    from repro_torch.training.train_step import loss_fn

    jcfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    shape = tbase.ShapeConfig("t", 8, 2, kind)
    jb, _ = jspecs.concrete_batch(jcfg, jbase.ShapeConfig("t", 8, 2, kind))
    tb, cache = tspecs.concrete_batch(tcfg, shape, torch.Generator().manual_seed(0))
    assert cache is None and set(tb) == set(jb)
    for k, v in tb.items():
        assert tuple(v.shape) == tuple(jb[k].shape), k
        assert str(v.dtype).split(".")[-1] == np.dtype(jb[k].dtype).name, k
        assert v.device.type == "cpu"
        if v.dtype == torch.int32:
            assert 0 <= int(v.min()) and int(v.max()) < max(2, tcfg.vocab_size - 1), k
    params = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    if kind == "train":
        loss, _ = loss_fn(tcfg, params, tb)
        assert bool(torch.isfinite(loss))
    else:
        inputs = {k: v for k, v in tb.items() if k != "tokens"}
        logits, _, _ = tlm.forward(tcfg, params, tb.get("tokens"), use_kernels=False, **inputs)
        assert tuple(logits.shape) == (2, 8, tcfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())
