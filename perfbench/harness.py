"""One run of one cell: set-up, the measured window, the traced waves, the
output check, the metrics.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, its file ``workloads/<cell>.json`` (the limits of its
output check), its configuration ``configs/<config>.json`` with the module
that file names (``references/<name>.py``: the plain reference, and the
family's parameter layout, FLOP count, attention shapes and the keys held
to the port), its traffic
``traffic/<traffic>.json``, and one reader ``metrics/<metric>.py`` for
every metric it reports. Adding a cell, a configuration, a traffic mix
or a metric adds files and edits none.

The window drives ``repro_torch.serving.engine.Engine.generate`` as the
port's serving path calls it (``TorchBackend``: a prompt batch and
``max_new``, greedy), one wave of ``concurrency`` calls after another: a
closed loop in which each session's next call waits for its previous one.
It closes at the end of the first wave that ends ``seconds`` or more after
it opened, and counts every call of every wave in it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import pathlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from perfbench import devtrace, judge, weights
from perfbench.traffic import Traffic

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# waves traced after the window, device activity only (the idle share, the
# kernels' times): at least this many, and this many seconds
TRACE_WAVES = 1
TRACE_SECONDS = 2.5


def _read(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    conf: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # workloads/<cell>.json: the output check's limits
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def load_cell(name: str) -> Cell:
    bench = _read(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell_file = _read(HERE / "workloads" / f"{name}.json")
    if (cell_file["config"], cell_file["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names another config or traffic than "
                         "BENCHMARK.json")

    def mine(metric):
        return name in metric.get("workloads", [name])

    return Cell(name=name, chips=entry["chips"], conf=_read(ROOT / config["file"]),
                traffic=_read(HERE / "traffic" / f"{entry['traffic']}.json"),
                limits=cell_file["limits"],
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def model_config(conf: dict):
    """The port's ``ModelConfig`` of the file's arch, held to the file: every
    key of the family's ``PORT_FIELDS`` (the widths, the activation, the
    norm, the family) and the dtype."""
    from repro_torch.configs import registry

    cfg = registry.get(conf["arch"])
    fields = judge.reference_module(conf).PORT_FIELDS
    wrong = {k: (conf[k], getattr(cfg, f)) for k, f in fields.items()
             if conf[k] != getattr(cfg, f)}
    if cfg.param_dtype != conf["dtype"]:
        wrong["param_dtype"] = (conf["dtype"], cfg.param_dtype)
    if wrong:
        raise ValueError(f"{conf['arch']}: the port's config differs from the file "
                         f"(file, port): {wrong}")
    return cfg


@dataclass
class Readings:
    """What one run measured; the metrics' readers take their numbers from
    it."""

    conf: dict  # configs/<config>.json
    family: object  # its module, references/<name>.py: layout, counts, reference
    traffic: Traffic
    setup_s: float
    window_s: float
    waves: list  # per wave of the window: (prompt length, seconds from submission to tokens)
    prefill_s: float  # EngineStats over the window
    decode_s: float
    decode_steps: int
    memory_peak_bytes: int
    trace: Optional[devtrace.Trace] = None  # device activity only, over the traced waves
    traced_waves: list = field(default_factory=list)  # prompt lengths of the traced waves
    # what the traced waves take untraced: the window's mean wave of each one's length
    untraced_s: Optional[float] = None

    @property
    def calls(self) -> int:
        return len(self.waves) * self.traffic.concurrency

    def call_latencies(self) -> list:
        """Every call's latency: all calls of a wave share its wave's."""
        return [lat for _, lat in self.waves for _ in range(self.traffic.concurrency)]


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def percentile(values, q: float) -> float:
    """Nearest-rank percentile."""
    s = sorted(values)
    return s[max(math.ceil(q / 100 * len(s)) - 1, 0)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
          cfg=None) -> dict:
    """One run: returns the result line's fields, ``checks`` last. ``cfg``
    (the port's ``ModelConfig``) defaults to ``model_config(cell.conf)``."""
    from repro_torch.serving.engine import Engine

    conf = cell.conf
    cfg = cfg or model_config(conf)
    params = weights.make(conf, seed, device)
    traffic = Traffic(cell.traffic, conf["vocab_size"], seed)
    engine = Engine(cfg, params, max_len=traffic.max_len, device=device)
    max_new = traffic.max_new
    # one warm wave at the longest prompt: it loads (or builds) every kernel
    # and leaves the allocator holding blocks for the largest wave
    engine.generate(traffic.warm_prompts(traffic.lengths[-1]), max_new=max_new)
    _sync(device)
    setup_s = time.perf_counter() - t0

    st0 = (engine.stats.prefill_s, engine.stats.decode_s, engine.stats.decode_tokens)
    waves, kept = [], []
    start = time.perf_counter()
    while True:
        prompts = traffic.prompts(len(waves))
        sent = time.perf_counter()
        out = engine.generate(prompts, max_new=max_new)
        done = time.perf_counter()
        waves.append((prompts.shape[1], done - sent))
        kept.append((prompts, out))
        if done - start >= seconds:
            break
    window_s = done - start
    st = engine.stats
    r = Readings(conf=conf, family=judge.reference_module(conf), traffic=traffic,
                 setup_s=setup_s, window_s=window_s, waves=waves,
                 prefill_s=st.prefill_s - st0[0], decode_s=st.decode_s - st0[1],
                 decode_steps=(st.decode_tokens - st0[2]) // traffic.concurrency,
                 memory_peak_bytes=0)

    stretch = {}
    if trace:
        timed = []  # (prompt length, seconds) of each traced wave

        def wave():
            p = traffic.prompts(len(waves) + len(timed))
            t = time.perf_counter()
            engine.generate(p, max_new=max_new)
            _sync(device)
            timed.append((p.shape[1], time.perf_counter() - t))

        def traced():
            t = time.perf_counter()
            while len(timed) < TRACE_WAVES or time.perf_counter() - t < TRACE_SECONDS:
                wave()

        # the idle share and the kernels' times from device activity alone;
        # then one wave with the host's operations too, for the idle gaps
        r.trace = devtrace.profile(traced, host=False)
        r.traced_waves = [s for s, _ in timed]
        r.untraced_s = untraced_seconds(waves, r.traced_waves)
        stretch["device_only"] = trace_stretch(waves, timed)
        n = len(timed)
        r.trace.gaps = devtrace.profile(wave, host=True).gaps
        stretch["with_host"] = trace_stretch(waves, timed[n:])
    if torch.device(device).type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    failed = traffic.concurrency * sum(not well_formed(o, traffic, conf["vocab_size"])
                                       for _, o in kept)
    # the program's state goes before the reference runs: only the weights stay
    del engine
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gap = judge.widest_gaps(conf, params, sampled_calls(traffic, kept), device)["served"]
    check_s = time.perf_counter() - t_check
    checks = judge.checks(cell.limits, failed, gap)
    correct = judge.verdict(checks)

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = load_reader(m["name"]).read(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": r.calls, "failed": failed, "metrics": metrics,
              "device": device_info(device, cell.chips, r.memory_peak_bytes, r.trace)}
    if r.trace is not None:
        result["breakdown"] = r.trace.breakdown()
        result["trace_cost_s"] = r.trace.cost_s
        result["trace_stretch"] = stretch
    result["waves"] = len(waves)
    result["wave_s"] = [[s, lat] for s, lat in waves]
    result["check_s"] = check_s
    result["checks"] = checks
    return result


def untraced_seconds(window, lengths) -> Optional[float]:
    """What waves of prompt ``lengths`` take untraced: for each, the mean of
    the window's waves [(length, seconds)] of that length; None where the
    window served one of the lengths not at all."""
    by_len = {}
    for s, lat in window:
        by_len.setdefault(s, []).append(lat)
    if not lengths or any(s not in by_len for s in lengths):
        return None
    return sum(sum(by_len[s]) / len(by_len[s]) for s in lengths)


def trace_stretch(window, traced) -> Optional[float]:
    """The traced waves [(length, seconds)] over what they take untraced."""
    base = untraced_seconds(window, [s for s, _ in traced])
    return None if base is None else sum(t for _, t in traced) / base


def sampled_calls(traffic: Traffic, kept) -> list:
    """The (prompt, served tokens) of the calls the output check compares,
    from the waves ``kept`` [(prompts, tokens)]."""
    return [(kept[w][0][i], kept[w][1][i])
            for w, i in traffic.sample([p.shape[1] for p, _ in kept])]


def device_info(device, chips: int, peak: int, trace) -> dict:
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": peak}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def card_check(chips: int) -> Optional[str]:
    """Why this machine cannot run a cell on ``chips`` cards, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards, the machine has {torch.cuda.device_count()}"
    return None


def forbidden_modules(modules) -> list:
    """Top-level module names of JAX or the JAX package, compared whole."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".")[0] for m in modules} & banned)


def well_formed(out: np.ndarray, traffic: Traffic, vocab: int) -> bool:
    """A wave's tokens: one row a call, ``max_new`` ids a row, in the vocabulary."""
    return (out.shape == (traffic.concurrency, traffic.max_new)
            and bool(out.min() >= 0) and bool(out.max() < vocab))


def cell_names() -> list:
    """The cells of ``BENCHMARK.json``, in its order."""
    return [w["name"] for w in _read(ROOT / "BENCHMARK.json")["workloads"]]
