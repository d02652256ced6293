"""The port's five workloads (``repro_torch.envs.workloads``) against
``repro.envs.workloads``: the same tasks for the same seed, the same
registry and the same error for an unknown name; the simulation's seeded
traffic (``sim_traffic``); and the env-side ``Workspace``."""

import dataclasses
import random

import pytest

pytest.importorskip("torch")

from repro.envs import workloads as jworkloads  # noqa: E402
from repro.envs.base import Workspace as JWorkspace  # noqa: E402
from repro_torch.envs import workloads  # noqa: E402
from repro_torch.envs.base import Workspace  # noqa: E402

ENVS = ["financebench", "tabmwp", "qasper", "aime", "gaia"]


def _task_fields(task):
    d = {f.name: getattr(task, f.name) for f in dataclasses.fields(task)}
    d.pop("workspace")  # a fresh, empty effect surface on both sides
    d["intent"] = dataclasses.asdict(task.intent)
    return d


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_matches_reference(env, seed):
    """Every field of every task (id, query, intent, slots, context,
    distractors, ground truth, context length) is equal."""
    got = workloads.get_env(env).generate(40, seed=seed)
    want = jworkloads.get_env(env).generate(40, seed=seed)
    assert [_task_fields(t) for t in got] == [_task_fields(t) for t in want]


@pytest.mark.parametrize("env", ENVS)
def test_env_surface_matches_reference(env):
    """The env's name, context range and intent set (keywords, rounds,
    expressions, paraphrases) are the reference's."""
    t, j = workloads.get_env(env), jworkloads.get_env(env)
    assert t.name == j.name == env
    assert t.context_tokens_range == j.context_tokens_range
    assert t.value_range == j.value_range
    assert [dataclasses.asdict(i) for i in t.intents()] == [
        dataclasses.asdict(i) for i in j.intents()]
    assert t.entities() == j.entities()


def test_registry_matches_reference():
    assert workloads.ALL_ENVS == jworkloads.ALL_ENVS == ENVS
    assert list(workloads.ENVS) == list(jworkloads.ENVS)
    with pytest.raises(KeyError) as got:
        workloads.get_env("webshop")
    with pytest.raises(KeyError) as want:
        jworkloads.get_env("webshop")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("scenario", ["skewed_reuse", "paraphrase_burst", "evict_then_hit",
                                      "uniform"])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_sim_traffic_matches_reference(scenario, seed):
    """Every client's op stream of the simulation, at the default sizes and
    at other ones, is the reference's; an unknown scenario raises its
    error."""
    assert workloads.SIM_SCENARIOS == jworkloads.SIM_SCENARIOS
    for sizes in ({}, {"n_ops": 23, "n_clients": 3, "batch": 12, "env": "financebench"}):
        got = workloads.sim_traffic(scenario, seed, **sizes)
        assert got == jworkloads.sim_traffic(scenario, seed, **sizes)
        assert len(got) == sizes.get("n_clients", 4)
    with pytest.raises(ValueError) as a:
        workloads.sim_traffic("nope", seed)
    with pytest.raises(ValueError) as b:
        jworkloads.sim_traffic("nope", seed)
    assert str(a.value) == str(b.value)


def test_workspace_matches_reference():
    """A seeded stream of writes, deletes and their undos (some run, in
    reverse): equal contents, ``snapshot()``, ``in``, ``len`` and the write
    and compensation counts after every op."""
    rng = random.Random(4)
    sides = [(Workspace(), []), (JWorkspace(), [])]
    for n in range(200):
        op, key = rng.random(), f"k{rng.randrange(6)}"
        undo_now = rng.random() < 0.3
        for ws, undos in sides:
            if op < 0.5:
                undos.append(ws.write(key, n))
            elif op < 0.8:
                undos.append(ws.delete(key))
            elif undos and undo_now:
                undos.pop()()
        (t, _), (j, _) = sides
        assert t.snapshot() == j.snapshot() and list(t.snapshot()) == sorted(t.keys())
        assert (key in t, len(t), t.writes, t.compensations_run) == (
            key in j, len(j), j.writes, j.compensations_run)
    assert sides[0][0].compensations_run > 0 and sides[0][0].writes > 100
