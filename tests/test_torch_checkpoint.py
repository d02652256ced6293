"""The port's ``CheckpointStore`` (``repro_torch.checkpoint.store``) against
``repro.checkpoint.store``: tests/test_training.py's checkpoint cases on the
port's store (roundtrip, atomicity and gc, the pinned segment, corruption),
the on-disk format shared by both packages (the same numpy tree with fp32,
bf16, fp8 and integer leaves gives equal manifests and shard contents, and
each store restores the other's checkpoint bit for bit), and a reference
olmo-1b smoke checkpoint restored into the port through ``params_from_jax``.
Restores are exact: every comparison here is bitwise."""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.store import CheckpointStore as JStore  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, adamw_init  # noqa: E402

torch.set_num_threads(2)


def _bits(x):
    """Any leaf as (dtype name, shape, raw bytes): bitwise comparison."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        return name, tuple(x.shape), x.contiguous().view(torch.uint8).numpy().tobytes() \
            if x.dim() else x.reshape(1).view(torch.uint8).numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.shape, np.ascontiguousarray(a).tobytes()


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bits(x) == _bits(y)


def _olmo_state():
    cfg = tregistry.get_smoke("olmo-1b")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return {"params": params, "opt": adamw_init(params, AdamWConfig())}


def test_checkpoint_roundtrip(tmp_path):
    state = _olmo_state()
    store = CheckpointStore(tmp_path, keep_last=2)
    store.save(7, state, extra={"step": 7})
    template = {"params": state["params"], "opt": state["opt"]}
    restored, extra = store.restore(template)
    assert extra["step"] == 7
    _same(restored, state)
    assert restored["params"]["embed"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32


def test_checkpoint_scalar_tree_roundtrip(tmp_path):
    """A bare scalar is a one-leaf tree (the fault runner's counter state)."""
    store = CheckpointStore(tmp_path)
    store.save(3, 5, extra={"step": 3})
    got, extra = store.restore(0)
    assert int(got) == 5 and extra == {"step": 3}
    assert JStore(tmp_path).restore(0)[0] == 5


def test_checkpoint_atomicity_and_gc(tmp_path):
    store = CheckpointStore(tmp_path, keep_last=2)
    for s in (10, 20, 30):
        store.save(s, {"x": torch.ones(4)})
    assert store.committed_steps() == [20, 30]  # keep_last pruned
    torn = tmp_path / "step_000000040"  # no COMMITTED: invisible
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert 40 not in store.committed_steps()
    tmp = tmp_path / ".tmp_step_000000050"
    tmp.mkdir()
    store.gc()
    assert not torn.exists() and not tmp.exists()


def test_checkpoint_gc_never_deletes_pinned_segment(tmp_path):
    live = {10}
    store = CheckpointStore(tmp_path, keep_last=2, pin_check=lambda s: s in live)
    for s in (10, 20, 30, 40):
        store.save(s, {"x": torch.ones(4)})
    assert store.committed_steps() == [10, 30, 40]  # the pin protects 10; 20 rotates
    restored, _ = store.restore({"x": torch.zeros(4)}, step=10)
    assert torch.equal(restored["x"], torch.ones(4))
    live.discard(10)
    store.gc()
    assert store.committed_steps() == [30, 40]


def test_checkpoint_corruption_detected(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, {"x": torch.arange(8, dtype=torch.float32)})
    shard = store._step_dir(1) / "shard_00000.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(Exception):
        store.restore({"x": torch.zeros(8)})


def test_checkpoint_crc_mismatch_raises_ioerror(tmp_path):
    """The manifest's crc32 is checked on load (a shard swapped for another
    whose zip is intact)."""
    store = CheckpointStore(tmp_path)
    store.save(1, {"x": torch.arange(8, dtype=torch.float32)})
    store.save(2, {"x": torch.arange(8, dtype=torch.float32) + 1})
    d1, d2 = store._step_dir(1), store._step_dir(2)
    (d2 / "shard_00000.npz").write_bytes((d1 / "shard_00000.npz").read_bytes())
    with pytest.raises(IOError, match="corruption"):
        store.restore({"x": torch.zeros(8)}, step=2)


def test_restore_strict_and_lenient(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, {"a": torch.ones(2)})
    template = {"a": torch.zeros(2), "b": torch.full((3,), 7.0)}
    with pytest.raises(KeyError):
        store.restore(template)
    got, _ = store.restore(template, strict=False)
    assert torch.equal(got["a"], torch.ones(2)) and torch.equal(got["b"], template["b"])


def _shared_tree():
    """One numpy tree for both packages: every dtype the store tags, nested
    dicts (keys out of order: jax sorts them), a list, a None subtree."""
    rs = np.random.RandomState(0)
    f32 = rs.standard_normal((5, 3)).astype(np.float32)
    return {
        "zeta": {"w": f32, "b": rs.standard_normal(3).astype(ml_dtypes.bfloat16)},
        "alpha": [rs.standard_normal((2, 4)).astype(ml_dtypes.float8_e4m3fn),
                  rs.standard_normal(6).astype(ml_dtypes.float8_e5m2),
                  np.asarray(12, np.int32)],
        "mid": {"skip": None, "ids": rs.randint(0, 100, (4,)).astype(np.int64),
                "flag": np.asarray([True, False])},
    }


@pytest.mark.parametrize("n_shards", [1, 3])
def test_format_matches_reference(tmp_path, n_shards):
    tree = _shared_tree()
    JStore(tmp_path / "j", n_shards=n_shards).save(4, tree, extra={"step": 4})
    CheckpointStore(tmp_path / "t", n_shards=n_shards).save(4, tree, extra={"step": 4})
    dj, dt = tmp_path / "j" / "step_000000004", tmp_path / "t" / "step_000000004"
    assert json.loads((dt / "manifest.json").read_text()) == \
        json.loads((dj / "manifest.json").read_text())
    assert sorted(p.name for p in dt.iterdir()) == sorted(p.name for p in dj.iterdir())
    for shard in dj.glob("shard_*.npz"):
        with np.load(shard) as a, np.load(dt / shard.name) as b:
            assert sorted(a.files) == sorted(b.files)
            for name in a.files:
                assert a[name].dtype == b[name].dtype
                assert a[name].tobytes() == b[name].tobytes()


@pytest.mark.parametrize("n_shards", [1, 3])
def test_each_store_restores_the_others(tmp_path, n_shards):
    tree = _shared_tree()
    JStore(tmp_path / "j", n_shards=n_shards).save(4, tree)
    CheckpointStore(tmp_path / "t", n_shards=n_shards).save(4, tree)
    template = jax.tree.map(np.zeros_like, tree)
    got_j, _ = JStore(tmp_path / "t").restore(template)  # the port's, read by repro
    got_t, _ = CheckpointStore(tmp_path / "j").restore(template)  # repro's, read by the port
    for got in (got_j, got_t):
        _same(jax.tree.leaves(got), jax.tree.leaves(tree))
    # a torch template gets torch leaves of the stored dtypes, bit for bit
    ttemplate = {
        "zeta": {"w": torch.zeros(5, 3), "b": torch.zeros(3, dtype=torch.bfloat16)},
        "alpha": [torch.zeros(2, 4, dtype=torch.float8_e4m3fn),
                  torch.zeros(6, dtype=torch.float8_e5m2), torch.zeros((), dtype=torch.int32)],
        "mid": {"skip": None, "ids": torch.zeros(4, dtype=torch.int64),
                "flag": torch.zeros(2, dtype=torch.bool)},
    }
    got, _ = CheckpointStore(tmp_path / "j").restore(ttemplate)
    assert got["zeta"]["b"].dtype == torch.bfloat16
    assert got["alpha"][0].dtype == torch.float8_e4m3fn and got["mid"]["skip"] is None
    for t, a in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):  # both in sorted-key order
        assert t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() == \
            np.ascontiguousarray(a).tobytes()


def test_torch_tree_saved_by_the_port_restores_in_the_reference(tmp_path):
    """bf16 torch leaves are stored as the reference stores ml_dtypes bf16."""
    state = _olmo_state()
    CheckpointStore(tmp_path).save(2, state)
    numpy_like = tree_map(lambda t: np.zeros(tuple(t.shape), _np_dtype(t)), state)
    got, _ = JStore(tmp_path).restore(numpy_like)
    assert jax.tree.leaves(got)[0].dtype.name in ("bfloat16", "float32", "int32")
    for t, a in zip(jax.tree.leaves(state), jax.tree.leaves(got)):  # sorted-key order
        assert t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() == \
            np.ascontiguousarray(a).tobytes()


def _np_dtype(t):
    return {torch.bfloat16: ml_dtypes.bfloat16, torch.float32: np.float32,
            torch.int32: np.int32}[t.dtype]


def test_reference_olmo_checkpoint_restores_into_the_port(tmp_path):
    """repro saves its olmo-1b smoke parameters (stacked layers); the port
    restores the numpy tree and carries it across with params_from_jax:
    every parameter equals the reference's, and so do the logits."""
    jcfg = jregistry.get_smoke("olmo-1b")
    tcfg = tregistry.get_smoke("olmo-1b")
    pj = jlm.init_params(jcfg, jax.random.PRNGKey(5))
    JStore(tmp_path, n_shards=2).save(9, pj, extra={"step": 9})
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), pj)
    restored, extra = CheckpointStore(tmp_path).restore(template)
    assert extra == {"step": 9}
    ported = tlm.params_from_jax(tcfg, restored)
    direct = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, pj))
    _same(ported, direct)
    toks = np.random.RandomState(1).randint(16, 400, (1, 12)).astype(np.int32)
    lj, _, _ = jlm.forward(jcfg, pj, {"tokens": toks})
    lt, _, _ = tlm.forward(tcfg, ported, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj, np.float32),
                               atol=3e-2, rtol=3e-2)  # bf16 smoke model, as test_torch_models
