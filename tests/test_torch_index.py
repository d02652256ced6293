"""The port's similarity index (``repro_torch.index`` and the top-k wrappers)
against ``repro``'s on the CPU: the plain top-k against the numpy oracle,
the Pallas kernel in interpret mode and ``repro.kernels.ops``; the bank's
embedding and slot order; the DeviceBank mirror on ``device="cpu"``; and the
three ported SimilarityIndex backends. The CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py."""

import random

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.envs.workloads import get_env as jget_env  # noqa: E402
from repro.index import SimilarityIndex as JIndex  # noqa: E402
from repro.index import embed_batch as jembed_batch  # noqa: E402
from repro.index.bank import EmbeddingBank as JBank  # noqa: E402
from repro.index.device import DeviceBank as JDeviceBank  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.similarity import topk_cosine as jtopk  # noqa: E402
from repro_torch.index import DIM, SimilarityIndex, embed_batch  # noqa: E402
from repro_torch.index.bank import EmbeddingBank  # noqa: E402
from repro_torch.index.device import DeviceBank  # noqa: E402
from repro_torch.kernels import ops, ref, similarity  # noqa: E402
from repro_torch.kernels.similarity import topk_cosine  # noqa: E402

torch.set_num_threads(2)

SCORE_TOL = 1e-6  # the two packages sum each dot product in other orders


def _unit_rows(n, seed):
    m = np.random.RandomState(seed).randn(n, DIM).astype(np.float32)
    m /= np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-9)
    return m


def _planted(q, n, seed):
    """Unit queries and bank with exact ties and zero rows planted: query 0
    equals bank row 0, which is duplicated further down the bank."""
    bank = _unit_rows(n, seed)
    queries = _unit_rows(q, seed + 1)
    if n >= 3:
        bank[n // 2] = bank[0]
        bank[n - 1] = 0.0
    if n >= 64:
        bank[[9, 40]] = bank[5]
        bank[10:14] = 0.0
        if q > 1:
            queries[1] = bank[5]
    if n:
        queries[0] = bank[0]
    return queries, bank


def _check(got, want):
    s, i = (np.asarray(x) for x in got)
    ws, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(i, wi)
    np.testing.assert_allclose(s, ws, atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("n", [0, 3, 64, 1000, 2500])
@pytest.mark.parametrize("q", [1, 8, 13])
def test_topk_plain_matches_reference(q, n, k):
    """ref.topk_cosine_ref and ops.batch_topk / resident_topk on CPU tensors
    against repro's numpy oracle, its Pallas kernel (interpret mode) and its
    ops: indices exactly, scores within 1e-6."""
    queries, bank = _planted(q, n, seed=q * 100 + n + k)
    want = jref.topk_cosine_ref(queries, bank, k)
    tq, tb = torch.from_numpy(queries), torch.from_numpy(bank)
    got = ref.topk_cosine_ref(tq, tb, k)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert tuple(got[0].shape) == tuple(got[1].shape) == (q, k)
    _check(got, want)
    _check(got, jtopk(queries, bank, k, interpret=True))
    _check(ops.batch_topk(tq, bank, k=k), jops.batch_topk(queries, bank, k=k))
    _check(ops.resident_topk(tq, tb, k=k), jops.resident_topk(queries, bank, k=k))
    if n:  # the planted exact tie comes out lowest row first
        i = got[1].numpy()
        assert i[0, 0] == 0 and (k == 1 or n < 3 or i[0, 1] == n // 2)
    if n < k:  # padding past N
        assert (got[1][:, n:] == -1).all() and (got[0][:, n:] == -1e30).all()


def test_topk_kernel_wrapper_refuses_what_it_cannot_launch():
    """The CUDA wrapper never runs the plain version: a CPU tensor, k > 32
    or a D it does not take raise before any launch."""
    q, b = torch.zeros(2, DIM), torch.zeros(5, DIM)
    with pytest.raises(ValueError, match="k=33"):
        topk_cosine(q, b, 33)
    with pytest.raises(ValueError, match="CUDA"):
        topk_cosine(q, b, 4)
    assert topk_cosine.launches == 0
    with pytest.raises(ValueError, match="bank on"):
        ops.resident_topk(q, b.to("meta"), k=1)


H100_SMS = 132


def test_launch_plan_at_the_agent_shape_writes_directly():
    """8 padded queries against the 64-row arena, k = 1: one CTA, which
    writes the result itself and touches no workspace."""
    plan = similarity.launch_plan(8, 64, DIM, 1, H100_SMS)
    assert (plan.qb, plan.n_qb, plan.n_split, plan.rows_per) == (8, 1, 1, 64)
    assert (plan.tile, plan.kg) == (64, 4)  # 2 row groups of 32 by 4 k-groups
    assert plan.direct and plan.ws_pairs == 0


def test_launch_plan_at_scale_gives_every_sm_a_cta():
    plan = similarity.launch_plan(64, 1_000_000, DIM, 4, H100_SMS)
    assert plan.n_qb * plan.n_split >= H100_SMS
    assert not plan.direct and plan.ws_pairs == 64 * plan.n_split * 4
    assert plan.qb * plan.n_qb >= 64


@pytest.mark.parametrize("d", [4, 384, 388, 1024])
@pytest.mark.parametrize("k", [1, 4, 32])
def test_launch_plan_covers_the_call_within_its_scratch(d, k):
    """Over batch sizes, bank sizes and forced split counts: the blocks
    cover every query and row, no CTA gets an empty range, a CTA fits the
    shared memory, and the workspace and counters that ``scratch`` keeps
    (on the CPU here) never fall short of what a plan uses; the counters
    start at 0."""
    similarity._scratch.clear()
    dev = torch.device("cpu")
    for q in (1, 7, 8, 9, 64, 130, 5000):
        for n in (1, 3, 64, 255, 256, 257, 20_000, 1_000_000):
            for ns in (None, 1, 7, 1000, 10**6):
                plan = similarity.launch_plan(q, n, d, k, H100_SMS, ns)
                assert plan.n_qb == -(-q // plan.qb) and (plan.n_qb - 1) * plan.qb < q
                assert plan.n_split * plan.rows_per >= n
                assert (plan.n_split - 1) * plan.rows_per < n
                assert plan.smem == similarity.smem_bytes(plan.qb, d, k, plan.kg)
                assert plan.kg == 1 or (plan.direct and plan.rows_per <= plan.tile)
                assert plan.smem <= similarity.SMEM_MAX
                assert plan.direct == (plan.n_split == 1)
                assert plan.ws_pairs == (0 if plan.direct else q * plan.n_split * k)
                assert plan.qb in similarity.QB_SIZES
                if ns is None:  # at most two CTAs an SM, at least 64 rows each
                    assert plan.n_split <= max(1, 2 * H100_SMS // plan.n_qb)
                    assert plan.n_split == 1 or plan.rows_per >= 64
                if plan.direct or plan.ws_pairs > 1 << 22:  # allocate up to 32 MiB here
                    continue
                ws, ctr = similarity.scratch(dev, 0, plan)
                assert ws.dtype == ctr.dtype == torch.int32
                assert ws.numel() >= 2 * plan.ws_pairs and ctr.numel() >= plan.n_qb
                assert not ctr.any()
    similarity._scratch.clear()


def test_launch_plan_refuses_a_zero_split():
    with pytest.raises(ValueError, match="n_split=0"):
        similarity.launch_plan(8, 64, DIM, 1, H100_SMS, 0)


# -- bank ---------------------------------------------------------------------


def _texts():
    """200 texts: FinanceBench queries and slot values, keyword-like
    phrases, paraphrases (reordered, extended, truncated words) and edge
    cases."""
    rng = random.Random(0)
    tasks = jget_env("financebench").generate(64, seed=0)
    base = [t.query for t in tasks]
    base += [" ".join(str(v) for v in t.slots.values()) for t in tasks[:16]]
    out = list(base)
    while len(out) < 196:
        words = rng.choice(base).split()
        rng.shuffle(words)
        cut = words[: rng.randint(1, len(words))]
        out.append(" ".join(cut + rng.sample(["analysis", "of", "ratio", "FY2023"], 1)))
    return out + ["", "a", "Net-Revenue  2023!!", "x" * 40]


def test_embed_batch_bitwise_equals_reference():
    texts = _texts()
    assert len(texts) == 200
    got, want = embed_batch(texts), jembed_batch(texts)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_bank_slots_match_reference_under_random_ops():
    """A seeded add/remove/clear stream gives the same slot for every key
    and the same arena as repro's EmbeddingBank (slots decide ties)."""
    rng = np.random.RandomState(3)
    b, jb = EmbeddingBank(initial_capacity=4), JBank(initial_capacity=4)
    for step in range(400):
        key = f"key-{rng.randint(60)}"
        r = rng.rand()
        if r < 0.6:
            assert b.add(key) == jb.add(key), step
        elif r < 0.97:
            assert b.remove(key) == jb.remove(key), step
        else:
            b.clear()
            jb.clear()
        assert b.high_water == jb.high_water and len(b) == len(jb)
    assert b.keys() == jb.keys()
    assert [b.slot_of(k) for k in b.keys()] == [jb.slot_of(k) for k in jb.keys()]
    np.testing.assert_array_equal(b.arena(), jb.arena())


# -- DeviceBank on the CPU ------------------------------------------------------


def _assert_lockstep(idx):
    dev = idx._device.arena.numpy()
    host = idx.bank.arena()
    n = min(dev.shape[0], host.shape[0])
    np.testing.assert_array_equal(dev[:n], host[:n])
    assert np.all(dev[n:] == 0.0) and np.all(host[n:] == 0.0)


def test_device_bank_mirror_and_counts_match_reference():
    """Interleaved add / add_batch / remove / clear with growth: the port's
    device arena equals its host arena and the reference's device arena,
    and the write counters equal the reference DeviceBank's."""
    rng = np.random.RandomState(13)
    idx = SimilarityIndex(backend="device", initial_capacity=4, device="cpu")
    jidx = JIndex(backend="device", initial_capacity=4)
    for step in range(300):
        r = rng.rand()
        key = f"key-{rng.randint(50)}"
        if r < 0.45:
            assert idx.add(key) == jidx.add(key)
        elif r < 0.6:
            keys = [f"wave-{rng.randint(30)}" for _ in range(rng.randint(1, 6))]
            assert idx.add_batch(keys) == jidx.add_batch(keys)
        elif r < 0.97:
            idx.remove(key)
            jidx.remove(key)
        else:
            idx.clear()
            jidx.clear()
        assert len(idx) == len(jidx)
    _assert_lockstep(idx)
    np.testing.assert_array_equal(idx._device.arena.numpy(), np.asarray(jidx._device.arena))
    for name in ("row_updates", "batched_updates", "clears", "grows", "capacity"):
        assert getattr(idx._device, name) == getattr(jidx._device, name), name


def test_device_bank_h2d_bytes_per_operation():
    """Uploads counted per operation: a row is D*4 bytes; a wave of n rows
    n*D*4 + n*4 (the reference pads n to a power of two, the port does
    not); clears and growth upload nothing."""
    vecs = _unit_rows(3, seed=1)
    b, jb = DeviceBank(capacity=2, device="cpu"), JDeviceBank(capacity=2)
    for bank in (b, jb):
        bank.set_row(0, vecs[0])
    assert b.h2d_bytes_total == jb.h2d_bytes_total == DIM * 4
    b.set_rows([1, 2, 5], vecs)
    jb.set_rows([1, 2, 5], vecs)
    assert b.h2d_bytes_total == DIM * 4 + 3 * DIM * 4 + 3 * 4
    assert jb.h2d_bytes_total == DIM * 4 + 4 * DIM * 4 + 4 * 4  # padded to 4
    assert b.capacity == jb.capacity == 8 and b.grows == jb.grows == 1
    before = b.h2d_bytes_total
    b.clear_row(1)
    b.ensure_capacity(20)
    b.clear()
    assert b.h2d_bytes_total == before and b.capacity == 32
    np.testing.assert_array_equal(b.arena.numpy(), 0.0)
    idx = SimilarityIndex(backend="device", device="cpu")
    idx.add_batch([f"k{i}" for i in range(5)])
    before = idx._device.h2d_bytes_total
    idx.topk(embed_batch(["k1", "k2", "k3"]), k=2)
    assert idx._device.h2d_bytes_total - before == 8 * DIM * 4  # queries only


# -- SimilarityIndex ------------------------------------------------------------


@pytest.mark.parametrize("backend", ["brute", "pallas", "device"])
def test_similarity_index_matches_reference(backend):
    """On a 2,000-key bank, before and after removals: equal topk slots and
    scores and equal best_match_batch keys, and no tombstone returned."""
    keys = [f"metric {i % 97} of segment {i // 97} fy{2000 + i % 23}" for i in range(2000)]
    kw = {"device": "cpu"} if backend != "brute" else {}
    idx, jidx = SimilarityIndex(backend=backend, **kw), JIndex(backend=backend)
    idx.add_batch(keys[:1200])
    jidx.add_batch(keys[:1200])
    for k in keys[1200:]:
        idx.add(k)
        jidx.add(k)
    rng = np.random.RandomState(5)
    probes = [keys[i] for i in rng.randint(0, 2000, 6)]
    probes += [p + " analysis" for p in probes[:3]] + ["quantum chromodynamics"]

    def same(k):
        s, i = idx.topk(probes, k=k)
        js, ji = jidx.topk(probes, k=k)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(s, js, atol=SCORE_TOL, rtol=0)
        assert idx.best_match_batch(probes, 0.8) == jidx.best_match_batch(probes, 0.8)
        assert [idx.best_match(p, 0.6) for p in probes[:3]] == [
            jidx.best_match(p, 0.6) for p in probes[:3]]
        return i

    same(4)
    for p in probes[:4]:
        idx.remove(p)
        jidx.remove(p)
    slots = same(4)
    live = {idx.bank.slot_of(k) for k in idx.bank.keys()}
    assert all(s == -1 or s in live for s in slots.ravel())
    assert idx.best_match(probes[0], threshold=0.999) != probes[0]


def test_similarity_index_masks_tombstones():
    idx = SimilarityIndex(backend="device", device="cpu")
    for kw in ("alpha beta", "gamma delta", "epsilon zeta"):
        idx.add(kw)
    idx.remove("gamma delta")
    q = -idx.bank.vector("alpha beta")  # the freed zero row would rank first
    scores, slots = idx.topk(q.reshape(1, -1), k=3)
    for c in range(3):
        assert slots[0, c] == -1 or idx.bank.key_of(int(slots[0, c])) is not None
        if slots[0, c] == -1:
            assert scores[0, c] <= -1e29


def test_similarity_index_refuses_unported_backends_and_missing_cuda(monkeypatch):
    """Every backend of the reference is ported (``auto`` and ``bucketed``
    since slice 8): only a name neither package has is refused. Without
    CUDA the device backends raise; the host backends need no device."""
    with pytest.raises(ValueError, match="not in"):
        SimilarityIndex(backend="faiss")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("pallas", "device"):  # the device defaults to CUDA
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SimilarityIndex(backend=backend)
    for backend in ("brute", "bucketed", "auto"):
        assert SimilarityIndex(backend=backend).device is None
