#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero without
printing the ok line):

1. the card: name and power limit (nvidia-smi), torch/CUDA versions; TF32
   is switched off for matmuls and cuDNN so fp32 references stay fp32;
2. the build: every kernel of the serving path is compiled from
   ``src/repro_torch/kernels/csrc/`` into ``build/kernels/`` (one nvcc per
   source, all at once);
3. kernels against their plain PyTorch versions on the card, at the three
   full-width head layouts of the deployment (16/16, 16/2, 48/8; hd 128)
   in bf16 and fp32, plus the decode kernel's bitwise batch-invariance
   check; then each kernel is timed with CUDA events beside its plain
   version and one PyTorch library call for the same function;
4. the model on the card against the model on the CPU: each arch at full
   width, depth cut to 2 layers, fp32, same weights;
5. serving: ``build_engines(DEFAULT, full=True)`` — nemotron-4-15b,
   olmo-1b and qwen2.5-3b at full published width in bf16, random weights
   from a fixed seed — then the ``apc`` agent on 16 FinanceBench tasks
   (seed 0). The kernels' launch counters are set to 0 just before and
   read just after; both must have risen, and the run must see at least
   one plan-cache hit and one miss.

Output: one ``{"kernels": [...]}`` line, one ``{"serve": {...}}`` line,
the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
LAYOUTS = {"olmo-1b": (16, 16, 128), "qwen2.5-3b": (16, 2, 128),
           "nemotron-4-15b": (48, 8, 128)}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # kernel vs plain: sums in another order
N_TASKS = 16


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, repeats: int = 5, calls: int = 20):
    """Device time of one call, as two numbers (ms):

    * ``device``: the median over ``repeats`` runs of ``calls`` back-to-back
      calls, each run timed with CUDA events and divided by ``calls``. A
      sleep kernel first holds the stream while the host queues the run, so
      the events bracket device work only, not the host's launch gaps;
    * ``call``: the median over ``repeats * calls`` single calls bracketed
      by events with no sleep ahead — what a caller on the host waits for,
      launch overhead included.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    device = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms of device time at 1.98 GHz
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        device.append(a.elapsed_time(b) / calls)
    call = []
    for _ in range(repeats * calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        call.append(a.elapsed_time(b))
    return statistics.median(device), statistics.median(call)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch):
    """Phase 3: every kernel against its plain version. Returns the max
    abs error per kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    err = {"flash_attention": 0.0, "decode_attention": 0.0}
    n = 0
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        tol = TOL[dname]

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dt)

        for arch, (hq, hkv, hd) in LAYOUTS.items():
            for S in (1, 37, 128, 152):
                for B in (1, 3):
                    for causal in ((True, False) if S == 37 else (True,)):
                        q, k, v = rnd(B, S, hq, hd), rnd(B, S, hkv, hd), rnd(B, S, hkv, hd)
                        o = flash_attention(q, k, v, causal=causal)
                        r = ref.flash_attention_ref(
                            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal).transpose(1, 2)
                        torch.cuda.synchronize()
                        e = (o.float() - r.float()).abs().max().item()
                        if not e <= tol:
                            raise AssertionError(
                                f"flash_attention {dname} {arch} S={S} B={B} "
                                f"causal={causal}: max abs err {e} > {tol}")
                        err["flash_attention"] = max(err["flash_attention"], e)
                        n += 1
            M = 192
            for lens in ((1, 100, 192), (192,), (37,)):
                B = len(lens)
                q, ck, cv = rnd(B, 1, hq, hd), rnd(B, M, hkv, hd), rnd(B, M, hkv, hd)
                L = torch.tensor(lens, dtype=torch.int32, device="cuda")
                o = decode_attention(q, ck, cv, L)
                r = ref.decode_attention_ref(q[:, 0], ck.transpose(1, 2),
                                             cv.transpose(1, 2), L)[:, None]
                torch.cuda.synchronize()
                e = (o.float() - r.float()).abs().max().item()
                if not e <= tol:
                    raise AssertionError(f"decode_attention {dname} {arch} lengths="
                                         f"{lens}: max abs err {e} > {tol}")
                err["decode_attention"] = max(err["decode_attention"], e)
                n += 1
                for b in range(B):  # batch invariance: bitwise
                    ob = decode_attention(q[b:b + 1], ck[b:b + 1], cv[b:b + 1], L[b:b + 1])
                    if not torch.equal(ob, o[b:b + 1]):
                        raise AssertionError(
                            f"decode_attention {dname} {arch} lengths={lens}: row {b} "
                            "of the batch differs from the row decoded alone")
    log(f"[kernels] {n} checks passed; max abs err {err} "
        f"(tolerance bf16 {TOL['bfloat16']}, fp32 {TOL['float32']})")
    return err


def _timed(torch, kernel, arch, shape, fn, plain, library, bound_ms, bound_by):
    ms, call_ms = time_ms(torch, fn)
    plain_ms, plain_call_ms = time_ms(torch, plain)
    library_ms, library_call_ms = time_ms(torch, library)
    return {"kernel": kernel, "arch": arch, "shape": shape, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "library_call_ms": library_call_ms}


def time_kernels(torch):
    """Phase 3b: kernel, plain version and library call at the serving
    path's shapes (B=1, bf16; prefill S=152 — the longest prompt the
    backend sends — and decode M=192 at length 168)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(1)
    dt, esz = torch.bfloat16, 2
    rows = []
    for arch, (hq, hkv, hd) in LAYOUTS.items():
        B, S = 1, 152
        q = torch.randn(B, S, hq, hd, generator=g, device="cuda").to(dt)
        k = torch.randn(B, S, hkv, hd, generator=g, device="cuda").to(dt)
        v = torch.randn(B, S, hkv, hd, generator=g, device="cuda").to(dt)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes = esz * B * S * hd * (2 * hq + 2 * hkv)
        flops = 4 * B * hq * hd * S * (S + 1) / 2  # causal pairs only
        bms, by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        rows.append(_timed(
            torch, "flash_attention", arch, f"B={B} S={S} Hq={hq} Hkv={hkv} hd={hd} bf16",
            lambda: flash_attention(q, k, v, causal=True),
            lambda: ref.flash_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True),
            bms, by))
        M, ln = 192, 168
        q1 = torch.randn(B, 1, hq, hd, generator=g, device="cuda").to(dt)
        ck = torch.randn(B, M, hkv, hd, generator=g, device="cuda").to(dt)
        cv = torch.randn(B, M, hkv, hd, generator=g, device="cuda").to(dt)
        L = torch.full((B,), ln, dtype=torch.int32, device="cuda")
        q1t = q1.transpose(1, 2).contiguous()
        ckt, cvt = ck.transpose(1, 2).contiguous(), cv.transpose(1, 2).contiguous()
        mask = (torch.arange(M, device="cuda")[None, :] < L[:, None])[:, None, None, :]
        nbytes = esz * B * hd * (2 * hq + 2 * hkv * ln) + 4 * B
        flops = 4 * B * hq * hd * ln
        bms, by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        rows.append(_timed(
            torch, "decode_attention", arch,
            f"B={B} M={M} len={ln} Hq={hq} Hkv={hkv} hd={hd} bf16",
            lambda: decode_attention(q1, ck, cv, L),
            lambda: ref.decode_attention_ref(q1[:, 0], ck.transpose(1, 2),
                                             cv.transpose(1, 2), L),
            lambda: F.scaled_dot_product_attention(q1t, ckt, cvt, attn_mask=mask,
                                                   enable_gqa=True),
            bms, by))
    for r in rows:
        log("[timing] " + json.dumps(r))
    return rows


def check_model(torch):
    """Phase 4: the model on the card (kernels) against the same model on
    the CPU (plain versions): full width, 2 layers, fp32, prefill of 37
    tokens then 3 decode steps; logits within atol 2e-3."""
    from repro_torch.configs import registry
    from repro_torch.models import lm

    for arch in registry.ARCH_NAMES:
        cfg = dataclasses.replace(registry.get(arch), num_layers=2, vocab_size=50_304,
                                  dtype="float32", param_dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(7)
        p_gpu = lm.init_params(cfg, gen, "cuda")
        p_cpu = lm.params_to(p_gpu, "cpu")
        toks = torch.randint(3, cfg.vocab_size, (1, 37), generator=torch.Generator().manual_seed(3))
        logits = {}
        for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            lg, c = lm.prefill(cfg, p, toks.to(dev), cache_len=48)
            outs = [lg[:, -1]]
            for t in (5, 11, 17):
                lg, c = lm.decode_step(cfg, p, c, torch.full((1, 1), t, device=dev))
                outs.append(lg[:, -1])
            logits[dev] = torch.cat(outs).cpu()
        if not torch.isfinite(logits["cuda"]).all():
            raise AssertionError(f"model {arch}: non-finite logits on the card")
        worst = (logits["cuda"] - logits["cpu"]).abs().max().item()
        if not worst <= 2e-3:
            raise AssertionError(f"model {arch}: card vs CPU logits differ by {worst}")
        log(f"[model] {arch} (2 layers, fp32): card vs CPU max |dlogit| {worst:.3e}")
        del p_gpu, p_cpu
        torch.cuda.empty_cache()


def serve(torch):
    """Phase 5: the paper's deployment served on the card."""
    import numpy as np

    from repro_torch.configs.apc_minion import DEFAULT
    from repro_torch.core.agent_loop import AgentConfig, PlanActAgent
    from repro_torch.core.cost_model import CostLedger
    from repro_torch.envs.finance import get_env
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import build_engines
    from repro_torch.serving.torch_backend import TorchBackend

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engines = build_engines(DEFAULT, full=True, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = {
        e.cfg.name: sum(t.numel() for t in _leaves(e.params))
        for e in {id(e): e for e in engines.values()}.values()
    }
    log(f"[serve] engines built in {init_s:.1f}s; params {n_params}; "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    backend = TorchBackend(engines, seed=0)
    ledger = CostLedger(pricing_map=dict(DEFAULT.pricing))
    agent = PlanActAgent(backend, ledger, AgentConfig(method="apc", cache_capacity=100))
    tasks = get_env("financebench").generate(N_TASKS, seed=0)

    flash_attention.launches = 0
    decode_attention.launches = 0
    t0 = time.perf_counter()
    recs = [agent.run_task(t) for t in tasks]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}

    hits = sum(r.hit for r in recs)
    if not (1 <= hits < len(recs)):
        raise AssertionError(f"serve: {hits} hits of {len(recs)}; need a hit and a miss")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"serve: kernel {name} was not launched")
    engine_s = sum(e.stats.prefill_s + e.stats.decode_s
                   for e in {id(e): e for e in engines.values()}.values())
    out = {
        "tasks": len(recs), "hits": hits, "hit_rate": hits / len(recs),
        "accuracy": sum(r.correct for r in recs) / len(recs),
        "cost_usd": ledger.total_cost(), "wall_s": wall, "engine_s": engine_s,
        "init_s": init_s, "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches,
        "calls": {role: u.calls for role, u in sorted(ledger.usage.items())},
        "engines": {
            role: {"arch": e.cfg.name, "prefill_tokens": e.stats.prefill_tokens,
                   "decode_tokens": e.stats.decode_tokens,
                   "prefill_s": e.stats.prefill_s, "decode_s": e.stats.decode_s,
                   **{f"{k}_tok_s": v for k, v in e.measured_rates().items() if k != "rtt"}}
            for role, e in engines.items()
        },
    }
    # what comes out is right: finite logits of the expected shape on every engine
    tok = np.asarray([backend.tok.encode(tasks[0].query)], np.int32)
    for e in {id(e): e for e in engines.values()}.values():
        logits, _ = e.prefill(tok)
        if tuple(logits.shape) != (1, e.cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"serve: {e.cfg.name} logits {tuple(logits.shape)} not finite")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    # phase 1: the card
    smi = nvidia_smi()
    log(f"[card] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[card] TF32 off for matmuls and cuDNN")

    # phase 2: the build
    t0 = time.perf_counter()
    names = sorted(_build.SIGNATURES)
    _build.build(names)
    log(f"[build] {names} built in {time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR}")
    for n, text in _build.build_logs.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {n}: {regs[:2]}")

    # phase 3: kernels against their plain versions, then timings
    err = check_kernels(torch)
    timing = time_kernels(torch)

    # phase 4: the model on the card against the CPU
    check_model(torch)

    # phase 5: serving
    srv = serve(torch)

    sources = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:102"),
               "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:95")}
    kernels = []
    for name, (src, replaces) in sources.items():
        # the representative shape: the largest attention of the path (nemotron)
        row = next(r for r in timing if r["kernel"] == name and r["arch"] == "nemotron-4-15b")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": srv["launches"][name], "max_abs_err": err[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"],
        })
    log(f"[serve] {srv['tasks']} tasks: accuracy {srv['accuracy']:.3f}, hit rate "
        f"{srv['hit_rate']:.3f}, cost ${srv['cost_usd']:.4f}, wall {srv['wall_s']:.1f}s, "
        f"peak memory {srv['max_memory_allocated_gib']:.2f} GiB, launches {srv['launches']}")
    log(f"[total] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serve": srv}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
