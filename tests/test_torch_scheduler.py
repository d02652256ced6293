"""The port's continuous-batching scheduler against ``repro``'s, under a
simulated clock: the same arrivals give the same slots, hedges, wasted
steps, completion order and latency percentiles."""

import random

import pytest

pytest.importorskip("torch")

from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402


class StepClock:
    """Simulated time: each read returns the time now; ``tick`` moves it
    by one decode step of the current batch."""

    def __init__(self, step_s):
        self.t, self.step_s = 0.0, step_s

    def __call__(self):
        return self.t

    def tick(self, batch):
        self.t += self.step_s * (1 + 0.1 * batch)


def _drive(mod, cfg_kw, seed):
    rng = random.Random(seed)
    clock = StepClock(0.25)
    b = mod.ContinuousBatcher(mod.SchedulerConfig(**cfg_kw), clock=clock)
    trace = []
    n = 0
    for _ in range(60):
        for _ in range(rng.randrange(3)):  # arrivals between steps
            b.submit(mod.Request(arrival=clock() + rng.random(), id=f"r{n}",
                                 prompt_tokens=rng.randrange(4, 64),
                                 max_new=rng.randrange(1, 40)))
            n += 1
        done = b.step()
        trace.append((done, [r.id for r in b.active], b.hedges, b.wasted_steps))
        clock.tick(len(b.active))
    summary = b.run_until_idle()
    order = [(r.id, r.started, r.finished, r.hedged, r.replica, r.generated) for r in b.done]
    return trace, summary, order


@pytest.mark.parametrize("cfg_kw", [
    {"max_batch": 8, "hedge_after_s": 5.0, "n_replicas": 2},
    {"max_batch": 3, "hedge_after_s": 1.0, "n_replicas": 3},
    {"max_batch": 4, "hedge_after_s": 0.5, "n_replicas": 1},  # no replica to hedge onto
])
@pytest.mark.parametrize("seed", [0, 1])
def test_continuous_batcher_matches_reference(cfg_kw, seed):
    got = _drive(tsched, cfg_kw, seed)
    assert got == _drive(jsched, cfg_kw, seed)
    trace, summary, order = got
    assert summary["completed"] == len(order) > 0
    assert (summary["hedges"] > 0) == (cfg_kw["n_replicas"] > 1)
    assert max(len(active) for _, active, _, _ in trace) <= cfg_kw["max_batch"]


def test_request_ordering_and_defaults_match_reference():
    """Requests queue by arrival time only; the runtime fields start as the
    reference's do."""
    reqs_t = [tsched.Request(arrival=a, id=str(a)) for a in (3.0, 1.0, 2.0)]
    reqs_j = [jsched.Request(arrival=a, id=str(a)) for a in (3.0, 1.0, 2.0)]
    assert [r.id for r in sorted(reqs_t)] == [r.id for r in sorted(reqs_j)] == ["1.0", "2.0", "3.0"]
    r = reqs_t[0]
    assert (r.max_new, r.tier, r.generated, r.hedged, r.replica) == (32, "actor", 0, False, 0)
    assert tsched.SchedulerConfig() == tsched.SchedulerConfig(max_batch=8, hedge_after_s=5.0,
                                                              n_replicas=2, step_time_fn=None)
