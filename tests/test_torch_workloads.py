"""The port's five workloads (``repro_torch.envs.workloads``) against
``repro.envs.workloads``: the same tasks for the same seed, the same
registry and the same error for an unknown name."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.envs import workloads as jworkloads  # noqa: E402
from repro_torch.envs import workloads  # noqa: E402

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
