#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero without
printing the ok line):

1. the card: name and power limit (nvidia-smi), torch/CUDA versions; TF32
   is switched off for matmuls and cuDNN so fp32 references stay fp32;
2. the build: every kernel of the port (flash_attention, decode_attention,
   paged_decode_attention, topk_cosine, wkv6, ssd, ssd_step, causal_conv) is
   compiled from ``src/repro_torch/kernels/csrc/`` into ``build/kernels/``
   (one nvcc per source, all at once);
3. kernels against their plain PyTorch versions on the card: the attention
   kernels at the three full-width head layouts of the deployment
   (16/16, 16/2, 48/8; hd 128) and zamba2's shared block (32/32, hd 80) in
   bf16 and fp32 (flash at S up to 152, 63/64/65 among them; decode at
   lengths 0 to M = 192, the split-K chunk's edges among them, also against
   the split-K plain version, length 0 giving zeros), plus the decode
   kernel's bitwise batch-invariance check;
   the wkv6 and SSD scan kernels at rwkv6-3b's (H 40, N 64) and zamba2's
   (H 80, P 64, Ns 64) layouts and the shapes of tests/test_kernels.py's
   sweeps, y and final state, bf16 and fp32 inputs, decays drawn as the
   model draws them and as the sweeps do; the Mamba-2 decode step's
   kernel (ssd_step, the state updated in place) against the plain step at
   zamba2's and Nemotron-H's layouts and every (P, Ns) the scan takes, and
   timed at the nemotron-h-47b cell's decode (B 16), where it must reach
   ``SSD_STEP_MIN_SHARE`` of its byte bound; the Mamba-2 prefill's conv
   kernel (causal_conv) against the plain conv, bit for bit, at
   Nemotron-H's and zamba2's layouts (the strided column slice of an
   in_proj output, with and without a carry, bf16 and fp32), and timed at
   the nemotron-h-47b cell's prefill wave (B 16, S 1,549), where it must
   reach ``CAUSAL_CONV_MIN_SHARE`` of its byte bound; the paged decode kernel at the
   deployment's layouts and the hd 64 / hd 32 shapes of tests/test_kernels.py, page sizes 8 to
   64, permuted pool rows, each result also bitwise equal to the dense
   decode kernel on the gathered pages and batch-invariant; the top-k
   kernel at Q in {1, 8, 64, 130}, N in {1, 3, 64, 20,000, 1,000,000}, k in
   {1, 4, 32} with planted exact ties and zero rows, also at D = 388 and
   1,024, plus its bitwise invariance to the batch and to the split count,
   one CUDA kernel a call (torch.profiler), and once through
   ``ops.batch_topk`` with a host bank (the ``pallas`` index backend, which
   uploads the bank every call); then each kernel is timed with CUDA events
   beside its plain version and a PyTorch library yardstick for the same
   function (and flash once more off the path, at S = 2,048);
4. the model on the card against the model on the CPU: each arch at full
   width, depth cut to 2 layers (zamba2: one group of 6, its decode steps
   launching ssd_step once a layer), fp32, same weights;
5. serving: the ``DEFAULT`` deployment — nemotron-4-15b, olmo-1b and
   qwen2.5-3b at full published width in bf16, depth cut to
   ``SERVE_DEPTHS``, random weights from their arch seeds — then four runs
   of 16 FinanceBench tasks (seed 0) on those engines, each with a fresh
   agent (``SERVE_RUNS``): ``apc`` with exact matching; directly after it
   the ``accuracy_optimal`` baseline, so that the paper's headline
   comparison reads two walls taken under the same host load; ``apc`` with
   fuzzy matching at 0.6 on the ``device`` index (a bank on the card
   searched by the top-k kernel) and the ``semantic`` baseline on the
   ``device`` index. Each run's hits, accuracy and cost must equal the
   reference's on the CPU (tests/test_torch_agent.py). Then the ``prefix``
   run on the same engines (``serve_prefix``): the paged KV prefix path of
   a second olmo-1b engine held to a full prefill, the two-tier router
   wired to its page pool (hits and misses pinned to the reference
   router's; the prefix cache's four counters read from its registry and
   from its attributes, which must agree), and the paged decode kernel
   over the pool's live pages.
   Last the ``recurrent`` run: the 16 tasks with exact ``apc`` on a
   deployment whose small planner and keyword extractor are rwkv6-3b and
   whose actor is zamba2-2.7b (full width, depth cut to ``SERVE_DEPTHS``,
   bf16, weights from their arch seeds; zamba2's published 32,000-entry
   vocabulary widened to the tokenizer's 50,304, as ``engine_config``
   does), the large planner the cut nemotron-4-15b engine; every prefill scan runs on the
   wkv6 or SSD kernel, zamba2's shared block on the attention kernels at
   hd 80. Before each run the kernels' launch counters are set to 0, and
   they are read just after: every kernel of the run's path must have
   risen, and in the recurrent run the attention kernels' hd-80 counts
   must be positive multiples of the shared block's applications, and
   ssd_step's of zamba2's Mamba-2 layers (zamba2's prefills launch
   causal_conv);
6. the paper's baselines, its other workloads and its second agent, on the
   ``DEFAULT`` engines of phase 5 (``BASELINE_RUNS``): ``full_history`` (16), ``cost_optimal``
   (8), ``cascade`` on 8 AIME tasks at default thresholds on the
   ``device`` index (its fuzzy and semantic stages on the top-k kernel),
   ``apc`` on 8 tasks each of TabMWP, QASPER and AIME, and the
   deep-research agent with APC on 16 GAIA tasks. Each run's hits,
   accuracy and cost must equal the reference's, and each must launch
   flash and decode attention (``cascade`` also top-k). Then the paper's
   headline comparison: the exact run against ``accuracy_optimal``, the
   run served directly after it;
7. the rest of the plan store, on the same engines: (a) the ``speculative``
   method (fuzzy 0.6 on the ``device`` index; a near hit executes the
   adapted template at once while the large planner verifies it, and the
   step journal commits, patches or rolls back) on 8 AIME and 16
   FinanceBench tasks (``SPEC_RUNS``), each pinned to the reference's hits,
   accuracy, cost and census of outcomes, each launching flash, decode and
   top-k; (b) ``serve_dcache``: the router over a 2-node replicated
   ``DistributedPlanCache`` whose shards each keep a bank on the card,
   with near-hit speculation, traced by ``repro_torch.obs``, through a
   mark-down and a restart with read-repair; its counters pinned to the
   reference router's, its top-k launches to the index calls of the same
   stream on the CPU, its span forest checked, and the restart must not
   grow the memory allocated on the card;
8. the other families (the moe, qk-norm and vlm archs served at
   ``SERVE_DEPTHS``, their prefix path, the FLAGSHIP deployment with kimi-k2 at one layer,
   whisper-tiny card against CPU);
9. the trainer (constants ``TRAIN_*`` to ``COLD_*`` state each check and
   tolerance): (a) olmo-1b at published width, ``TRAIN_LAYERS`` layers,
   trained through the port's
   ``FaultTolerantRunner`` with its checkpoints (a temporary directory)
   and one rollback from an injected NaN; (b) one step card against CPU;
   (c) the trained weights served through the flash and decode kernels,
   and every CUDA kernel wrapper refusing an input that requires grad;
   (d) the plan cache's cold tier on the ``device`` index;
10. the deterministic simulation (``repro_torch.sim``; constants ``SIM_*``):
   the cells of ``python -m repro_torch.sim --check``. (a) every fuzzy cell
   (the paraphrase scenario under each plan, the speculation plan and the
   fuzzy-scatter and speculation audits) at seeds below ``SIM_SEEDS`` with its shard
   indexes and the oracle's twin indexes on the card's ``device`` backend:
   clean or caught as expected, run twice with equal trace hash and span
   digest, its trace hash equal to the same cell on the CPU on the same
   backend, top-k launched; (b) every other cell at seed 0, its trace hash
   pinned to the reference's; (c) a soak of the paraphrase scenario under
   crash/restart at 10x the default ops;
11. the multi-device layer (``repro_torch.distributed``, ``launch/mesh.py``;
   constants ``MULTI_*``), each part in processes of its own
   (``spawn_local``, every sub-phase under a timeout that kills every
   rank): (a) one NCCL rank at world size 1 serving olmo-1b at published
   size through ``Engine(mesh=)``, bitwise equal to the engine without a
   mesh, launches equal, the NCCL collectives counted, and the FSDP
   gather's backward a NCCL reduce-scatter; (b) four gloo ranks sharing
   the card: tensor-parallel serving with flash and decode at 4 local
   heads (launches pinned, each call held to its plain version, logits
   within ``MULTI_TP_TOL`` of the unsharded engine's; phase 3 also checks
   both kernels at that layout), expert parallelism (granite-moe, 8
   experts a rank) against the grouped path, a sharded train step under
   the TP and FSDP profiles against the one-rank step and, bit for bit,
   against AdamW from its own gradients, the GPipe pipeline, the int8
   all-reduce on CUDA equal to the CPU's, and a reshard onto a smaller
   mesh. The KV prefix path under a mesh: (a) ``Engine(mesh=, kv_prefix=)``
   bitwise equal to ``Engine(kv_prefix=)``; (b) ``tp_prefix``, each rank
   over its own page pool (1/4 of the whole pool's bytes), flash and
   decode at 4 local heads pinned, logits within ``MULTI_TP_TOL``, the
   paged kernel over the rank's pool bitwise against dense decode; the
   train step also under ``seq_parallel`` and remat "dots"; beside (a)
   and (b), a dry-run (``launch/dryrun.py``) of ``MULTI_DRYRUN_CELLS`` on
   the host's CPU. Four ranks on one card check correctness and launch
   shapes, not four-card speed; they start beside (a) and wait for its
   references. (c) the dry-run's memory on the card (``dryrun --device
   cuda``) of ``CARD_DRYRUN_CELLS`` in a process of its own, its meta
   runs beside (a) and its card runs after (a): each cell's peak inside 80 GB with temporaries above 0, flash
   once a layer at S = 32,768 for the prefill cell, decode once a layer
   over a 32,768-token cache for the decode cell;
12. the example drivers' twins (``repro_torch.examples``; constants
   ``QUICKSTART_LINES`` to ``EXAMPLE_TRAIN_STEPS``) through their entry
   points: ``quickstart`` and ``distributed_cache_demo`` print the
   reference's lines, ``serve_agent --full`` serves at published widths
   with the reference example's per-task lines, hits, accuracy, cost and
   tokens, launching flash and decode, and ``train_small`` trains through
   one NaN rollback to a falling loss.

Output: a ``[phase]`` line as each phase ends, one ``{"kernels": [...]}``
line, one ``{"serve": {...}}`` line, one ``{"baselines": {...}}`` line, one
``{"obs": {...}}`` line (phase 7(b): counters, span counts,
``engine.generate`` p50/p99 per arch, the per-shard ``cache.*`` series),
one ``{"train": {...}}`` line (phase 9: step seconds and tokens/s,
checkpoint bytes, save and restore seconds, peak memory, the card-vs-CPU
and served-logits errors, the cold runs), one ``{"sim": {...}}`` line
(phase 10: cells, hash checks, audit trips, top-k launches, the soak,
seconds), one ``{"multi": {...}}`` line (phase 11: backends, each check's
error, launches a rank, collective calls and bytes by kind, staged bytes,
seconds, peak memory; (c) the card's dry-run cells), one ``{"examples":
{...}}`` line (phase 12: each twin's printed lines, serve_agent's launches
and wall), one ``{"phases": {...}}`` line (each phase's seconds, and the
total), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Phase 7(b)'s trace is written to
``trace-out/dcache/trace.jsonl`` and ``trace_chrome.json``.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import kernels as kernel_table  # noqa: E402  (imports nothing at load)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
LAYOUTS = {"olmo-1b": (16, 16, 128), "qwen2.5-3b": (16, 2, 128),
           "nemotron-4-15b": (48, 8, 128)}
# the other families' attention layouts (Hq, Hkv, hd): GQA groups of 2
# (granite, hd 64), 4 (qwen3), 7 (qwen2-vl) and 8 (kimi-k2)
FAMILY_LAYOUTS = {"granite-moe-1b-a400m": (16, 8, 64), "qwen3-4b": (32, 8, 128),
                  "qwen2-vl-7b": (28, 4, 128), "kimi-k2-1t-a32b": (64, 8, 128)}
# zamba2-2.7b's shared attention block: the attention kernels' hd-80 case
ATTN_LAYOUTS = {**LAYOUTS, "zamba2-2.7b": (32, 32, 80), **FAMILY_LAYOUTS}
# phase 11's tensor-parallel serving: each rank's local heads (olmo-1b at
# TP 4), checked in phase 3 beside the layouts above
TP_LAYOUTS = {"olmo-1b tp4": (4, 4, 128)}
# the prefix families' paged layouts beside the DEFAULT ones
PAGED_FAMILY_LAYOUTS = {a: FAMILY_LAYOUTS[a] for a in ("granite-moe-1b-a400m", "qwen2-vl-7b")}
# whisper-tiny's encoder: bidirectional flash over the stub frontend's
# frames (B, S, Hq, Hkv, hd)
WHISPER_ENC = (1, 1500, 6, 6, 64)
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # kernel vs plain: sums in another order
# the attention checks' prefill lengths (63/64/65 straddle one 64-row tile)
# and decode batches of lengths; the last batch puts 0, 1, the edges of the
# decode kernels' 32-position split-K chunk (31, 32, 33), the served 168 and
# the full M = 192 in one call
FLASH_SEQS = (1, 37, 63, 64, 65, 128, 152)
LONG_S = 2048  # the off-path flash timing's prefill length
DECODE_LENGTHS = ((1, 100, 192), (192,), (37,), (0, 1, 31, 32, 33, 168, 192))
# the scan kernels at full width: rwkv6-3b (H, N) and zamba2-2.7b (H, P, Ns)
WKV6_LAYOUT = (40, 64)
SSD_LAYOUT = (80, 64, 64)
# Nemotron-H's scan: (H, P, G), 256 heads of 64 reading B and C in 8 groups,
# at its state sizes Ns (47B's 256; 128, the smaller models')
SSD_GROUPED_LAYOUT = (256, 64, 8)
SSD_GROUPED_NS = (128, 256)
SCAN_SEQS = (1, 37, 128, 152, 300)
# the other layouts the scan wrappers take, checked at H 3, B 2 in the sweep
# draw: wkv6 head sizes and ssd (P, Ns) besides the full-width ones above
# and the sweeps' own (N 16; (32, 16), (64, 64))
SCAN_EXTRA_WKV6 = (32,)
SCAN_EXTRA_SSD = ((32, 32), (32, 64), (64, 16), (64, 32))
SCAN_EXTRA_SEQS = (37, 152)
# the scans' timing rows: the served prefill (B 1, S 152), then off the path
# a batch of 4 and a long prompt (S = LONG_S)
SCAN_TIMED = ((1, 152), (4, 152), (1, LONG_S))
# the nemotron-h-47b.plan_miss cell's prefill scan: a wave of 16 prompts
# of its longest length
SSD_CELL_TIMED = (16, 1549)
# the decode step's kernel (ssd_step), checked at zamba2's layout
# (SSD_LAYOUT, B/C shared), Nemotron-H's (SSD_GROUPED_LAYOUT at each of
# SSD_GROUPED_NS) and the other (P, Ns) the wrappers take (H 3), at these
# batches; timed at the nemotron-h-47b.plan_miss cell's decode (B 16, Ns
# 256), where it must reach SSD_STEP_MIN_SHARE of its bound, the state's
# bytes read and written once
SSD_STEP_BATCHES = (1, 16)
SSD_STEP_CELL_B = 16
SSD_STEP_MIN_SHARE = 0.75
# the prefill's conv kernel (causal_conv, K = CONV_TAPS), checked at these
# layouts (batch, steps, in_proj width, first conv column, channels: xc is
# the model's strided column slice of the in_proj output) and timed at
# Nemotron-H-47B's, the nemotron-h-47b.plan_miss cell's prefill wave, where
# it must reach CAUSAL_CONV_MIN_SHARE of its bound
CONV_LAYOUTS = {"nemotron-h-47b": (16, 1549, 37120, 16384, 20480),
                "zamba2-2.7b": (2, 300, 10448, 5120, 5248)}
CONV_TAPS = 4
CAUSAL_CONV_MIN_SHARE = 0.75
MODEL_CHUNK = 128  # both configs' ssm.chunk_size, the plain versions' chunk
# scan kernel vs plain: |err| <= atol * max(1, max|plain|) + rtol * |plain|,
# elementwise, with tests/test_kernels.py's atol and rtol (wkv6 2e-4 / 1e-3,
# ssd 5e-4 / 1e-3). atol scales with the largest value: the recurrence and
# the chunked form round sums of that size in other orders. The inputs are
# read in bf16 or fp32 and both sides compute in fp32, so one tolerance
# serves both types.
SCAN_TOL = {"wkv6": (2e-4, 1e-3), "ssd": (5e-4, 1e-3), "ssd_step": (5e-4, 1e-3)}
N_TASKS = 16
# top-k kernel (3xTF32 on the tensor cores: hi.hi + hi.lo + lo.hi, each
# operand split as hi = tf32(x), lo = x - hi, each 32-dim window's sum added
# into an fp32 sum) vs plain (float64 sum rounded to fp32)
TOPK_TOL = 1e-5
TOPK_PRODUCTS = 3  # tensor-core products a multiply-add: hi.hi, hi.lo, lo.hi
# bank rows -> (queries, k) of the calls whose CUDA kernels are counted
TOPK_PROFILED = {64: (8, 1), 1_000_000: (64, 4)}


@dataclasses.dataclass(frozen=True)
class PlanAct:
    """(backend, ledger) -> a ``PlanActAgent`` with these AgentConfig
    fields over a 100-entry plan cache."""

    cfg: dict

    def __call__(self, backend, ledger):
        from repro_torch.core.agent_loop import AgentConfig, PlanActAgent

        return PlanActAgent(backend, ledger, AgentConfig(cache_capacity=100, **self.cfg))


def deep_research(backend, ledger):
    """(backend, ledger) -> run_deep_research's APC arm on ``backend``
    instead of the simulated one."""
    from repro_torch.core.cache import PlanCache
    from repro_torch.core.deep_research import DeepResearchAgent, DeepResearchConfig

    return DeepResearchAgent(backend, ledger, DeepResearchConfig(seed=0), PlanCache(100))


# a serving run: (name, env, tasks of seed 0, the agent's factory, the
# reference's (hits, accuracy, cost) on those tasks (tests/test_torch_agent.py),
# the kernels the run's path must launch)
ATTN = ("flash_attention", "decode_attention")
ATTN_TOPK = ATTN + ("topk_cosine",)
# phase 5's runs on the DEFAULT engines. accuracy_optimal runs the exact
# run's 16 tasks directly after it, so that the paper's headline comparison
# (APC against that baseline) reads two walls taken under the same host load
SERVE_RUNS = (
    ("exact", "financebench", N_TASKS, PlanAct({"method": "apc"}), (2, 0.875, 0.2987), ATTN),
    ("accuracy_optimal", "financebench", N_TASKS, PlanAct({"method": "accuracy_optimal"}),
     (0, 0.9375, 0.3444), ATTN),
    ("fuzzy", "financebench", N_TASKS,
     PlanAct({"method": "apc", "fuzzy": True, "fuzzy_threshold": 0.6,
              "index_backend": "device"}), (3, 0.8125, 0.2804), ATTN_TOPK),
    ("semantic", "financebench", N_TASKS,
     PlanAct({"method": "semantic", "index_backend": "device"}), (2, 0.8125, 0.2953),
     ATTN_TOPK),
)
# phase 6's runs, on the same engines: the other baselines, workloads and agent
BASELINE_RUNS = (
    ("full_history", "financebench", 16, PlanAct({"method": "full_history"}),
     (2, 0.9375, 0.2966), ATTN),
    ("cost_optimal", "financebench", 8, PlanAct({"method": "cost_optimal"}),
     (0, 0.75, 0.0095), ATTN),
    ("cascade", "aime", 8, PlanAct({"method": "cascade", "index_backend": "device"}),
     (4, 0.75, 0.0866), ATTN_TOPK),
    ("apc_tabmwp", "tabmwp", 8, PlanAct({"method": "apc"}), (1, 0.875, 0.1301), ATTN),
    ("apc_qasper", "qasper", 8, PlanAct({"method": "apc"}), (2, 0.75, 0.1127), ATTN),
    ("apc_aime", "aime", 8, PlanAct({"method": "apc"}), (1, 1.0, 0.1416), ATTN),
    ("deep_research", "gaia", 16, deep_research, (1, 0.9375, 0.4195), ATTN),
)
# phase 7(a)'s runs, on the same engines: the `speculative` method (fuzzy
# 0.6 on the `device` index: near hits execute at once while the large
# planner verifies); each row also pins the reference's census of
# speculation outcomes (tests/test_torch_speculative.py)
SPEC = PlanAct({"method": "speculative", "fuzzy_threshold": 0.6, "index_backend": "device"})
SPEC_RUNS = (
    ("speculative_aime", "aime", 8, SPEC, (2, 1.0, 0.1351), ATTN_TOPK,
     {"commit": 1, "patch": 0, "rollback": 0}),
    ("speculative_financebench", "financebench", 16, SPEC, (2, 0.875, 0.3108), ATTN_TOPK,
     {"commit": 0, "patch": 0, "rollback": 1}),
)
# the recurrent run: these roles on the ssm and hybrid archs (the large
# planner stays the deployment's nemotron-4-15b engine), exact `apc`; the
# reference's (hits, accuracy, cost) on that deployment
# (tests/test_torch_agent.py), and the kernels its path must launch
RECURRENT_ROLES = {"small_planner": "rwkv6-3b", "keyword_extractor": "rwkv6-3b",
                   "actor": "zamba2-2.7b"}
RECURRENT_EXPECT = (2, 0.875, 0.2987)
RECURRENT_KERNELS = ("wkv6", "ssd", "ssd_step", "causal_conv", "flash_attention",
                     "decode_attention")
# phase 8's two runs, exact `apc` on the apc_qasper run's 8 QASPER tasks (2
# hits; 8 FinanceBench tasks give none, so the small planner would never
# serve): `families` puts the moe, dense-qk-norm and vlm archs in these roles
# (the large planner stays the nemotron-4-15b engine), `flagship` is the
# FLAGSHIP deployment with kimi-k2 cut to one layer. The reference's (hits,
# accuracy, cost) on each (tests/test_torch_families.py)
FAMILIES_ROLES = {"small_planner": "granite-moe-1b-a400m", "keyword_extractor": "qwen3-4b",
                  "actor": "qwen2-vl-7b"}
PHASE8_ENV, PHASE8_TASKS = "qasper", 8
PHASE8_EXPECT = {"families": (2, 0.75, 0.1127), "flagship": (2, 0.75, 0.1127)}
FLAGSHIP_DEPTH = 1  # kimi-k2's 61 layers are ~2 TB in bf16; one card holds 80 GB
# every engine phases 5-8 serve (the DEFAULT deployment, the recurrent and
# the families runs) is built at its published width and arch seed with its
# depth cut to these layers, to hold the script well inside its time limit:
# decode is host-bound, so a run's seconds follow its layers. Published
# depths: nemotron-4-15b 32, olmo-1b 16, qwen2.5-3b 36, rwkv6-3b 32,
# zamba2-2.7b 54 (12 keeps two applications of its shared block),
# granite-moe-1b-a400m 24, qwen3-4b 36, qwen2-vl-7b 28. Hits, accuracy,
# cost, the censuses and the router's counters do not depend on depth;
# flash and decode launches per task do. Phase 11 serves olmo-1b, and phase
# 12 the DEFAULT deployment, at full depth
SERVE_DEPTHS = {"nemotron-4-15b": 2, "olmo-1b": 2, "qwen2.5-3b": 2, "rwkv6-3b": 2,
                "zamba2-2.7b": 12, "granite-moe-1b-a400m": 2, "qwen3-4b": 2, "qwen2-vl-7b": 2}
# phase 4 checks kimi-k2 at its attention width with this many experts: 2
# layers of all 384 are 135 GB in fp32
MODEL_KIMI_EXPERTS = 16

# phase 9, the trainer: (a) olmo-1b at published width (d 2,048, bf16
# params) cut to TRAIN_LAYERS of its 16 layers (the checkpoints' save and
# restore set the phase's time, and their bytes follow the layers) under launch/train.py's settings (AdamW lr 1e-3, fp32 state)
# on its synthetic batches through the FaultTolerantRunner, a checkpoint
# every 3 steps and 1 kept, a NaN injected at step 4: one rollback to step
# 3, whose restored state must equal the saved one bit for bit and whose
# re-run of step 4 must give the first try's loss within a relative 1e-3
# (the card's atomics change the last bits);
TRAIN_ARCH, TRAIN_LAYERS = "olmo-1b", 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 64, 6, 1e-3
TRAIN_CKPT_EVERY, TRAIN_KEEP_LAST, TRAIN_NAN_AT = 3, 1, 4
TRAIN_SHARDS = 8  # checkpoint shards, written and read in parallel (8 host cores)
TRAIN_RERUN_RTOL = 1e-3
# (b) one step at olmo-1b's width cut to GRAD_LAYERS layers, fp32, batch
# GRAD_BATCH x seq TRAIN_SEQ, card against CPU on the same weights and
# batch: |loss diff| <= GRAD_LOSS_RTOL * |loss|, and each gradient's largest
# |diff| <= GRAD_RTOL * its largest |g| on the CPU (both fp32, TF32 off: sums
# in other orders only);
GRAD_LAYERS, GRAD_BATCH = 2, 2
GRAD_LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3
# (c) (a)'s final weights served by an Engine (bf16): the prefill logits
# against the training path's forward on the same tokens within SERVED_TOL
# of the largest |logit| (flash's bf16 P and tiling against the plain fp32
# softmax), then SERVED_NEW greedy decode steps; each CUDA wrapper must
# refuse an input that requires grad;
SERVED_PROMPT, SERVED_NEW, SERVED_TOL = 48, 8, 2.0 ** -4
# (d) the cold tier: tests/test_memory.py::test_cold_tier_conformance's op
# stream (12 keys into 4 hot slots a node, looked up, one removed, cleared)
# through PlanCache and a 2-node DistributedPlanCache (replication 1) with a
# cold_dir, fuzzy on the `device` index, per eviction policy, at the test's
# threshold 0.7 (every key is 0.833 from every other, so the fuzzy stage
# resolves each miss to a hot key) and at 0.9 (it resolves none, so every
# miss reaches the cold tier and promotes). The reference's outcome on the
# CPU (tests/test_torch_tiered.py), keyed "store/policy/threshold": the
# lookups, each node's hot and cold key ids, the cold_hits / spills /
# promotes totals, remove's [first, lookup, second], and after clear the
# hot and cold sizes and the lookups that miss
COLD_KEYS = 12
COLD_THRESHOLDS = (0.7, 0.9)
COLD_EXPECT = {
    "plan/lru/0.7": {
        "lookup": [8, 8, 8, 8, 8, 8, 8, 8, 8, 9, 10, 11], "hot": [[8, 9, 10, 11]],
        "cold": [[0, 1, 2, 3, 4, 5, 6, 7]], "cold_hits": 0, "spills": 8, "promotes": 0,
        "remove": [True, 8, False], "cleared": [0, 0, 12]},
    "plan/lru/0.9": {
        "lookup": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], "hot": [[4, 5, 6, 7]],
        "cold": [[0, 1, 2, 3, 8, 9, 10, 11]], "cold_hits": 8, "spills": 16, "promotes": 8,
        "remove": [True, None, False], "cleared": [0, 0, 12]},
    "plan/lfu/0.7": {
        "lookup": [8, 8, 8, 8, 8, 8, 8, 8, 8, 9, 10, 11], "hot": [[8, 9, 10, 11]],
        "cold": [[0, 1, 2, 3, 4, 5, 6, 7]], "cold_hits": 0, "spills": 8, "promotes": 0,
        "remove": [True, 8, False], "cleared": [0, 0, 12]},
    "plan/lfu/0.9": {
        "lookup": [None, None, None, None, None, None, None, None, 8, 9, 10, 11],
        "hot": [[8, 9, 10, 11]], "cold": [[0, 1, 2, 3, 4, 5, 6, 7]], "cold_hits": 0,
        "spills": 16, "promotes": 8, "remove": [True, None, False], "cleared": [0, 0, 12]},
    "plan/cost/0.7": {
        "lookup": [8, 8, 8, 8, 8, 8, 8, 8, 8, 9, 10, 11], "hot": [[8, 9, 10, 11]],
        "cold": [[0, 1, 2, 3, 4, 5, 6, 7]], "cold_hits": 0, "spills": 8, "promotes": 0,
        "remove": [True, 8, False], "cleared": [0, 0, 12]},
    "plan/cost/0.9": {
        "lookup": [None, None, None, None, None, None, None, None, 8, 9, 10, 11],
        "hot": [[8, 9, 10, 11]], "cold": [[0, 1, 2, 3, 4, 5, 6, 7]], "cold_hits": 0,
        "spills": 16, "promotes": 8, "remove": [True, None, False], "cleared": [0, 0, 12]},
    "distributed/lru/0.7": {
        "lookup": [2, 6, 2, 6, 6, 5, 6, 7, 8, 9, 10, 11],
        "hot": [[6, 8, 9, 10], [2, 5, 7, 11]], "cold": [[1, 3, 4], [0]], "cold_hits": 0,
        "spills": 4, "promotes": 0, "remove": [True, 2, False], "cleared": [0, 0, 12]},
    "distributed/lru/0.9": {
        "lookup": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
        "hot": [[1, 3, 4, 10], [0, 5, 7, 11]], "cold": [[6, 8, 9], [2]], "cold_hits": 4,
        "spills": 8, "promotes": 4, "remove": [True, None, False], "cleared": [0, 0, 12]},
    "distributed/lfu/0.7": {
        "lookup": [2, 6, 2, 6, 6, 5, 6, 7, 8, 9, 10, 11],
        "hot": [[6, 8, 9, 10], [2, 5, 7, 11]], "cold": [[1, 3, 4], [0]], "cold_hits": 0,
        "spills": 4, "promotes": 0, "remove": [True, 2, False], "cleared": [0, 0, 12]},
    "distributed/lfu/0.9": {
        "lookup": [None, None, 2, None, None, 5, 6, 7, 8, 9, 10, 11],
        "hot": [[6, 8, 9, 10], [2, 5, 7, 11]], "cold": [[1, 3, 4], [0]], "cold_hits": 0,
        "spills": 8, "promotes": 4, "remove": [True, None, False], "cleared": [0, 0, 12]},
    "distributed/cost/0.7": {
        "lookup": [2, 6, 2, 6, 6, 5, 6, 7, 8, 9, 10, 11],
        "hot": [[6, 8, 9, 10], [2, 5, 7, 11]], "cold": [[1, 3, 4], [0]], "cold_hits": 0,
        "spills": 4, "promotes": 0, "remove": [True, 2, False], "cleared": [0, 0, 12]},
    "distributed/cost/0.9": {
        "lookup": [None, None, 2, None, None, 5, 6, 7, 8, 9, 10, 11],
        "hot": [[6, 8, 9, 10], [2, 5, 7, 11]], "cold": [[1, 3, 4], [0]], "cold_hits": 0,
        "spills": 8, "promotes": 4, "remove": [True, None, False], "cleared": [0, 0, 12]},
}


# phase 10, the deterministic simulation (repro_torch.sim) on the card: the
# cells of ``python -m repro_torch.sim --check`` (``matrix_cells``). (a) the
# fuzzy cells (those whose normalized config has fuzzy=True: every shard
# index and every oracle twin on the ``device`` backend, so each lookup wave
# launches top-k) at seeds 0..SIM_SEEDS-1 (``--check`` on the CPU runs 5;
# each further seed repeats the same cells' checks on another stream), each run twice on the card (equal
# trace hash and span digest) and once on the CPU on the same backend (equal
# trace hash); (b) every other cell at seed 0, its trace hash pinned to the
# reference's (``python -m repro.sim``; tests/test_torch_sim.py holds the
# pins to it); (c) the soak, SIM_SOAK at 10x the default ops. A clean cell
# must show no violation; an audit cell (one guard ablated) must trip one of
# SIM_ORACLES[guard] (tests/test_sim.py's EXPECTED_ORACLES by guard)
SIM_SEEDS = 1
SIM_SOAK = {"seed": 0, "scenario": "paraphrase_burst", "fault": "crash_restart", "n_ops": 600}
SIM_ORACLES = {
    "crash_fallthrough": {"durability"},
    "replica_ack": {"linearizability", "durability", "control_plane"},
    "hedge_failover": {"completeness"},
    "evict_after_wave": {"eviction_order", "durability", "phantom"},
    "churn_rehome": {"durability", "linearizability", "control_plane"},
    "cachegen_fallback": {"cachegen_loss"},
    "cold_gc_refcount": {"durability"},
    "ttl_expiry": {"phantom", "control_plane"},
    "spec_rollback": {"spec_leak"},
    "spec_verify_timeout": {"spec_liveness"},
    "fuzzy_scatter": {"durability"},
}
SIM_REF_HASHES = {  # seed 0, by cell tag without its "s0-"
    "skewed_reuse-none": "0e78d7776fd22038dc648efa1cb736bc",
    "skewed_reuse-crash_restart": "7c81f0606382e5ab7ac800ffad6c78b2",
    "skewed_reuse-replica_lag": "ed48100896f9b808e7589d85531b4dec",
    "skewed_reuse-hedge_timeout": "c966097d8cbfa459ee9848dbd742b370",
    "skewed_reuse-membership_churn": "1501bc99d15138b32833f0b1ecbd1b57",
    "skewed_reuse-async_cachegen": "0ac1785019e94ef51b3ddf405c1f949e",
    "skewed_reuse-ttl_churn": "154992485e567b9203d2a4adff430848",
    "evict_then_hit-none": "3dc8dcae9ebed31528fbd4ae2211232f",
    "evict_then_hit-crash_restart": "98a83c74a24a997c69a28f56d2d5b437",
    "evict_then_hit-replica_lag": "4b0d26fd117de4eaf78cf4fe8dafd1fd",
    "evict_then_hit-hedge_timeout": "efe64b3be1b44fee277eaec3fed5a90f",
    "evict_then_hit-mid_wave_evict": "369ae363514c7f982625d91dabc92a61",
    "evict_then_hit-membership_churn": "3e8a77715f34765e2966ab853d2c78a6",
    "evict_then_hit-async_cachegen": "952b275810eb1607d5512c99b36bc075",
    "evict_then_hit-cold_tier": "d4ec68ca3e3255b3ffdc44f56f88d915",
    "uniform-none": "1bd2e3ea28ad81f0d2060e6abd794df1",
    "uniform-crash_restart": "3ef8b3413d24b3773ca836c5a4ad73d7",
    "uniform-replica_lag": "8d20f110ca625badfd6fedc6bd06d8dc",
    "uniform-hedge_timeout": "5a78d143d7e0fa0460ac11cd53ead6bc",
    "uniform-membership_churn": "066adc87d2a5857fde2d0256df233424",
    "uniform-async_cachegen": "bc097dc4fd7741ee4baa53f6138ae8ad",
    "ablate-cachegen_fallback": "2e61e8670b853df1f7b058838a477a7f",
    "ablate-cold_gc_refcount": "c11a7d0cd5a468f2ba2326ac8843d20b",
    "ablate-crash_fallthrough": "fbb329f69df897f518506ad7771c8c32",
    "ablate-hedge_failover": "8f821d5a6fe2e71584ffd84e69710e4c",
    "ablate-churn_rehome": "15ea20a3594f2b4ef7c25763680a7d25",
    "ablate-evict_after_wave": "369ae363514c7f982625d91dabc92a61",
    "ablate-replica_ack": "6907da0912f121e7553a003172f92dec",
    "ablate-ttl_expiry": "e3616d349c5966a9c10c231c87159c36",
}

# phase 11, the multi-device layer (repro_torch.distributed, launch/mesh.py)
# on the one card. (a) One NCCL rank at world size 1, mesh (1, 1) over
# ("data", "model"): MULTI_ARCH at published size (bf16, arch seed) served
# through Engine(mesh=) must give the same tokens and logits, bit for bit,
# and the same flash / decode launches, as the engine without a mesh, on
# MULTI_PROMPTS FinanceBench queries (seed 0, right-padded) for MULTI_NEW
# greedy tokens, with the NCCL collectives counted. (b) Four gloo ranks
# sharing the card (spawn_local; every CUDA operand of a collective staged
# through the host), each sub-phase under MULTI_PHASE_TIMEOUT_S:
#   tp_serve: MULTI_ARCH bf16 on mesh (1, 4) under its serving profile, a
#     MULTI_PROMPT_LEN-token prompt (the queries run together) prefilled
#     and decoded MULTI_NEW steps on (a)'s unsharded greedy tokens: each
#     step's largest |logit - unsharded| <= MULTI_TP_TOL * the largest
#     |logit| (each rank's row shard sums in bf16 before the psum, the
#     unsharded product accumulates all of it in fp32 once); flash and
#     decode launch at 4 local heads (16 q, 16 kv / 4), once a layer a
#     prefill and a decode step; then a free greedy run, its tokens matching
#     (a)'s counted;
#   ep: MULTI_EP_ARCH at published width cut to MULTI_EP_LAYERS layers, fp32,
#     mode "ep" (32 experts, 8 a rank), at capacity factor 8 (nothing drops)
#     against the unsharded grouped path, <= MULTI_EP_TOL of the largest
#     |logit|; the pairs dropped at the published 1.25 reported;
#   train: one AdamW step of MULTI_ARCH at published width cut to
#     MULTI_TRAIN_LAYERS layers, fp32, on mesh (2, 2) under the serving (TP)
#     and train (FSDP) profiles (remat "full"), against the one-rank step
#     on the card: the loss, each gradient relative to its leaf's largest
#     |g|, and every parameter whose |g| >= MULTI_TRAIN_GMIN within
#     MULTI_TRAIN_TOL. Every parameter, whatever its |g|, is held by two
#     exact checks: the step equals, bit for bit, AdamW run on the shards
#     from the sharded gradients and their norm; and the gathered result
#     equals, bit for bit, one-rank AdamW from the gathered gradients and
#     that norm. (AdamW's first step moves a parameter by lr * g / (|g| +
#     eps): where |g| is near eps (1e-8), gradients that the two reduction
#     orders round ~1e-9 apart (fp32) move it up to ~lr / 4 apart, so the
#     one-rank step holds those parameters to nothing tighter);
#   pipeline: pipeline_apply over 4 stages (MULTI_PIPE = L, D, B; 4
#     microbatches), forward within 1e-5 and gradient within 1e-3 of
#     sequential_reference (tests/test_distributed.py's bounds, here each
#     relative to the larger of 1 and the largest |value|);
#   allreduce: compressed_allreduce of a (1, MULTI_AR_N) gradient a rank on
#     CUDA tensors equal, bit for bit, to the same call on CPU tensors, and
#     within 0.02 of the mean relative to its largest |value|;
#   reshard: the train step's (2, 2) shards resharded onto (1, 2) over the
#     first two ranks, gathered back bit for bit.
# The KV prefix path under a mesh: (a) also serves MULTI_PREFIX_PROMPTS (4
# rows: the long prompt's first MULTI_PREFIX_LEN tokens as the template, a
# 24-token suffix each) through Engine(mesh=, kv_prefix=) and Engine(
# kv_prefix=): the registering prefill, then the suffix-only prefill from
# the pool and MULTI_NEW - 1 greedy decode steps, tokens and logits bit for
# bit and launches equal. (b)'s tp_prefix runs the same on (1, 4) in bf16,
# each rank over its own pool (MULTI_PREFIX_PAGES pages of
# MULTI_PREFIX_PAGE tokens, its 4 of the 16 kv heads: 1/4 of the whole
# pool's bytes), under (a)'s greedy tokens: logits within MULTI_TP_TOL of
# (a)'s unsharded prefix engine, flash (the registering prefill) and
# decode at 4 / 4 heads pinned to the unit, each call held to its plain
# version, and the paged kernel over the rank's pool bitwise equal to the
# dense decode kernel on the gathered pages. (b)'s train also takes the
# serving profile with seq_parallel and with remat "dots" (the sharded
# gradients, their norm and AdamW on the shards, held to the one-rank step
# as the TP profile's). A dry-run of MULTI_DRYRUN_CELLS (launch/dryrun.py:
# the meta device, a fake process group at world 256 / 512) runs on the
# host's CPU beside (a) and (b), in a process of its own.
MULTI_ARCH = "olmo-1b"
# MULTI_NEW: each decode step is a psum a layer through every rank, staged
# through the host under gloo, so (a)'s and (b)'s serving seconds follow it
MULTI_PROMPTS, MULTI_NEW, MULTI_PROMPT_LEN = 4, 8, 152
MULTI_TP_TOL = 2.0 ** -4
MULTI_EP_ARCH, MULTI_EP_LAYERS, MULTI_EP_BATCH, MULTI_EP_TOL = (
    "granite-moe-1b-a400m", 4, (2, 64), 1e-4)
# MULTI_TRAIN_LAYERS: each layout's check gathers every parameter and
# gradient (fp32) through the host, so its seconds follow the layers
MULTI_TRAIN_LAYERS, MULTI_TRAIN_BATCH, MULTI_TRAIN_TOL = 1, (4, 65), 1e-4
MULTI_TRAIN_GMIN = 1e-6
MULTI_PIPE = (8, 256, 32)
MULTI_AR_N = 1 << 20
MULTI_TIMEOUT_S, MULTI_PHASE_TIMEOUT_S = 420, 150
MULTI_PREFIX_LEN, MULTI_PREFIX_PAGE, MULTI_PREFIX_PAGES = 128, 32, 16
MULTI_PREFIX_ROWS, MULTI_PREFIX_SUFFIX = 4, 24
MULTI_DRYRUN_CELLS = (("olmo-1b", "prefill_32k", "single"), ("qwen3-4b", "decode_32k", "single"),
                      ("olmo-1b", "train_4k", "multi"))
# (c) the dry-run's memory on the card (dryrun --device cuda) after (a),
# beside (b)'s ranks (its allocator's peak is its own process's), in a
# process of its own: the two serving cells of
# MULTI_DRYRUN_CELLS and olmo-1b's train cell on the single-pod mesh. Its
# multi-pod train cell runs all 256 rows x 4,096 tokens on every rank (256
# rows do not split over 512 ranks): 16 remat checkpoints of 4.3 GB each
# pass 80 GB before the loss, so the sweep records it out of memory. The
# prefill cell runs flash once a layer (S = 32,768), the decode cell decode
# once a layer (a 32,768-token cache), the train step no kernel.
CARD_DRYRUN_CELLS = (("olmo-1b", "prefill_32k", "single"), ("qwen3-4b", "decode_32k", "single"),
                     ("olmo-1b", "train_4k", "single"))
CARD_DRYRUN_KERNEL = {"prefill_32k": "flash_attention", "decode_32k": "decode_attention"}

# phase 12: the example drivers' twins (repro_torch.examples), each through
# its entry point on the card. quickstart and distributed_cache_demo are
# host-only: their lines are the reference's (examples/*.py on the CPU). A
# quickstart row's latency is a simulated latency plus the cache lookups'
# measured time, which no pin can hold: the twin prints the two parts to
# stderr, the simulated part is pinned (QUICKSTART_SIMULATED_S, the twin's
# on the CPU, within QUICKSTART_SIMULATED_TOL), and the row's printed
# latency is held to the sum (QUICKSTART_LINES' latency column is the
# reference's CPU reading, lookups included). serve_agent runs at published
# widths; its hits, accuracy, cost and tokens served come from the
# simulated behavioural layer and do not depend on the widths, so they are
# the reference example's at --n EXAMPLE_SERVE_N (its per-task lines and
# summary but the wall). train_small runs EXAMPLE_TRAIN_STEPS steps with
# the NaN at half of them.
QUICKSTART_LINES = (
    "method                accuracy   cost $  latency s   hit%",
    "accuracy_optimal         0.892    2.438     2769.8   0.0%",
    "cost_optimal             0.433    0.126     1362.4   0.0%",
    "semantic                 0.550    1.471     1670.1  39.2%",
    "full_history             0.808    1.524     2013.0  38.3%",
    "apc                      0.867    1.535     2218.0  38.3%",
    "cascade                  0.792    1.388     2052.8  45.0%",
    "speculative              0.867    1.534     2212.5  40.0%",
    "",
    "APC vs accuracy-optimal: cost -37.1%, latency -19.9%, accuracy kept 97.2% "
    "(paper: -50.31%, -27.28%, 96.61%)",
)
QUICKSTART_SIMULATED_S = {
    "accuracy_optimal": 2769.803243678161, "cost_optimal": 1362.443909090909,
    "semantic": 1670.1077988505747, "full_history": 2013.012364367816,
    "apc": 2218.0361749738768, "cascade": 2052.821645088819,
    "speculative": 2212.5088445141064,
}
QUICKSTART_SIMULATED_TOL = 1e-6  # (latency + lookup) - lookup, summed over 120 tasks
DCACHE_DEMO_LINES = (
    "== populate a 6-node replicated cache from a real APC run ==",
    "run: accuracy=0.87 hit_rate=0.38 entries=72",
    "load by node: {'cache-0': 37, 'cache-1': 28, 'cache-2': 31, 'cache-3': 13, "
    "'cache-4': 19, 'cache-5': 16}",
    "",
    "== crash one node: replicas keep serving ==",
    "after cache-3 down: 72/72 keys still served",
    "",
    "== elastic scale-out: add two nodes ==",
    "load by node: {'cache-0': 19, 'cache-1': 21, 'cache-2': 26, 'cache-3': 8, "
    "'cache-4': 15, 'cache-5': 13, 'cache-6': 22, 'cache-7': 20}",
    "all keys reachable after rescale: 72/72",
    "",
    "== graceful decommission (keys re-homed, not lost) ==",
    "after removing cache-0: 72/72 keys reachable",
)
EXAMPLE_SERVE_N = 2  # at 4 the script took about 800 s on the card (PERF.md)
SERVE_AGENT_LINES = (  # after the tiers line; the summary's wall left out
    "  [  1] MISS kw=weekly total                         correct=True",
    "  [  2] MISS kw=discounted price                     correct=True",
    "",
    "n=2  accuracy=1.00  hit_rate=0.00  cost=$0.037",
    "engine tokens served: {'large_planner': 260, 'small_planner': 56, 'actor': 98, "
    "'keyword_extractor': 56}",
)
EXAMPLE_TRAIN_STEPS = 60


# the prefix phase's router run: the 16 tasks in route_batch waves of 4 over
# a 4-entry plan cache; each wave arrives three times in a row (the first
# misses, the second hits and registers each template's prefix on a pool
# miss, the third hits and reuses it); the reference router's (hits, misses)
# on that keyword stream (tests/test_torch_router.py)
ROUTER_CAPACITY = 4
ROUTER_WAVE = 4
ROUTER_REPEATS = 3
ROUTER_EXPECT = (32, 16)
ROUTER_NEW = 8  # tokens each planner call generates in the router run


def router_waves(tasks):
    """The router run's arrival waves: ``tasks`` in waves of ROUTER_WAVE,
    each sent ROUTER_REPEATS times in a row."""
    waves = []
    for i in range(0, len(tasks), ROUTER_WAVE):
        waves += [tasks[i:i + ROUTER_WAVE]] * ROUTER_REPEATS
    return waves


# phase 7(b): the traced router over a DistributedPlanCache of 2 nodes,
# replication 2, fuzzy at 0.6 on the `device` index (a bank on the card per
# shard) with ROUTER_CAPACITY entries a node. It routes the 16 tasks in
# `dcache_waves`; cache-1 is marked down after the sixth wave and restarted
# (recover=True) after the eighth. The reference router's counters on that
# stream, and the index calls (one top-k launch each) the port's CPU run of
# it makes (tests/test_torch_distributed_cache.py)
DCACHE_NODES = 2
DCACHE_DOWN_AFTER = 6
DCACHE_RESTART_AFTER = 8
DCACHE_EXPECT = {"requests": 48, "hits": 31, "misses": 17, "speculations": 18,
                 "spec_commits": 16, "spec_rollbacks": 2, "spec_sync_verifies": 0,
                 "tokens_saved": 371}
DCACHE_TOPK_CALLS = 22
# the span chain every traced route_batch must show (tools/check_trace.py's)
SERVING_CHAIN = ("router.route_batch", "dcache.lookup_batch", "dcache.tier",
                 "cache.lookup_batch", "match.stage")


def dcache_waves(tasks):
    """router_waves with each request a (task, arrival) pair: the r-th
    arrival of a wave asks under its intent's r-th keyword (the canonical
    one, then the paraphrases, the last repeated), so the second arrival is
    a near hit."""
    waves = []
    for i in range(0, len(tasks), ROUTER_WAVE):
        waves += [[(t, r) for t in tasks[i:i + ROUTER_WAVE]] for r in range(ROUTER_REPEATS)]
    return waves


def dcache_keyword(request):
    task, r = request
    kws = (task.intent.keyword, *task.intent.paraphrase_keywords)
    return kws[min(r, len(kws) - 1)]


def dcache_verdict(tasks):
    """The speculation verifier's verdict, a pure function of (request
    keyword, matched key): agree iff the near hit matched its intent's
    canonical keyword (a template admitted under a paraphrase is itself a
    speculative copy)."""
    canonical = {k: t.intent.keyword for t in tasks
                 for k in (t.intent.keyword, *t.intent.paraphrase_keywords)}
    return lambda kw, matched_key: matched_key == canonical.get(kw)


def drive_dcache(router, cache, waves, probe=lambda: None):
    """Route ``waves``, with cache-1 marked down after wave
    DCACHE_DOWN_AFTER and restarted after DCACHE_RESTART_AFTER. Returns the
    entries the restart repaired, and ``probe()`` read just before and just
    after the restart."""
    out = None
    for w, wave in enumerate(waves, 1):
        router.route_batch(wave)
        if w == DCACHE_DOWN_AFTER:
            cache.mark_down("cache-1")
        if w == DCACHE_RESTART_AFTER:
            before = probe()
            repaired = cache.restart_node("cache-1", recover=True)
            out = (repaired, before, probe())
    return out


def check_span_forest(spans, span_names, event_names):
    """The traced router's span forest: every name catalogued, every parent
    present, at least one SERVING_CHAIN, ``engine.generate`` spans under
    route spans, and a ``cache.attribution`` hit carrying ``tokens_saved``.
    Returns the span counts by name, the number of serving chains and the
    number of ``engine.generate`` spans under route spans."""
    by_id = {s["span_id"]: s for s in spans}

    def ancestors(s):
        pid = s["parent_id"]
        while pid is not None:
            yield by_id[pid]
            pid = by_id[pid]["parent_id"]

    for s in spans:
        if s["name"] not in span_names:
            raise AssertionError(f"span {s['name']!r} is not in the catalog")
        if s["parent_id"] is not None and s["parent_id"] not in by_id:
            raise AssertionError(f"span {s['span_id']} has no parent {s['parent_id']}")
        for ev in s["events"]:
            if ev["name"] not in event_names:
                raise AssertionError(f"event {ev['name']!r} is not in the catalog")
    chains = 0
    for s in spans:
        if s["name"] == SERVING_CHAIN[-1]:
            names = [a["name"] for a in ancestors(s)][::-1]
            it = iter(names)
            chains += all(n in it for n in SERVING_CHAIN[:-1])
    if not chains:
        raise AssertionError("no span chain " + " -> ".join(SERVING_CHAIN))
    routed = [s for s in spans if s["name"] == "engine.generate"
              and any(a["name"] == "router.route_batch" for a in ancestors(s))]
    if not routed:
        raise AssertionError("no engine.generate span under a router.route_batch span")
    if not any(ev["name"] == "cache.attribution" and ev["attrs"].get("hit")
               and isinstance(ev["attrs"].get("tokens_saved"), (int, float))
               for s in spans for ev in s["events"]):
        raise AssertionError("no cache.attribution hit carrying tokens_saved")
    counts = {}
    for s in spans:
        counts[s["name"]] = counts.get(s["name"], 0) + 1
    return dict(sorted(counts.items())), chains, len(routed)


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
      the events bracket device work only, not the host's launch gaps. If
      the device reached the first event before the host had queued the
      whole run (a plain version of many small ops), the run is discarded
      and the sleep doubled, until it outlasts twice the host's time to
      queue a run (measured once, without a sleep). If the device still
      gets there first, the launch queue filled while the host waited:
      the run is halved until it fits in the queue. At one call, ``fn``
      waits for the device itself (a copy from pageable host memory): no
      sleep can hold the stream ahead of it, so its runs go without one,
      and their events bracket the host's gaps;
    * ``call``: the median over ``repeats * calls`` single calls bracketed
      by events with no sleep ahead — what a caller on the host waits for,
      launch overhead included.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    device = []
    cycles = 50_000_000  # ~25 ms of device time at 1.98 GHz
    n, blocks = calls, False
    while len(device) < repeats:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if not blocks:
            torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        host_late = a.query()  # the sleep ran out while the host queued
        b.record()
        b.synchronize()
        if host_late and not blocks:
            if cycles / 1.98e9 <= 2 * queue_s:
                cycles *= 2
            elif n > 1:
                n //= 2
            else:
                blocks = True
            continue
        device.append(a.elapsed_time(b) / n)
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


def ptxas_summary(text: str) -> list:
    """Each kernel of an ``nvcc -Xptxas -v`` log as "name<type,hd[,rows]>:
    registers, static shared memory, spill stores / loads (bytes)". Dynamic
    shared memory is set at launch and not in the log."""
    import re

    out, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            mangled = m.group(1)
            # the kernel's identifier: a length prefix, then that many characters
            name = next((c for g in re.finditer(r"(?=(\d+))", mangled)
                         for c in [mangled[g.end(1):g.end(1) + int(g.group(1))]]
                         if re.fullmatch(r"[a-z]\w*(?:kernel|stage\d)", c)), mangled)
            args = ["bf16" if "bfloat16" in mangled else "f32"]
            args += re.findall(r"Li(\d+)E", mangled)
            args += [r for r in ("DenseRows", "PagedRows") if r in mangled]
            cur = {"fn": f"{name}<{','.join(args)}>"}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur["spill"] = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["regs"] = int(m.group(1))
            cur["smem"] = int(sm.group(1)) if sm else 0
    return [f"{c['fn']}: {c.get('regs')} regs, smem {c.get('smem')}, spill "
            f"{c.get('spill')}" for c in out]


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch):
    """Phase 3: the attention kernels against their plain versions at every
    layout of ATTN_LAYOUTS and TP_LAYOUTS, flash at S in FLASH_SEQS, decode at the batches
    of DECODE_LENGTHS (also against the split-K plain version; a row of
    length 0 must be zeros, and each row bitwise equal to that row decoded
    alone); and flash bidirectional at whisper-tiny's encoder (WHISPER_ENC).
    Returns the max abs error and the number of checks per kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import CHUNK, decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    err = {"flash_attention": 0.0, "decode_attention": 0.0}
    n = {"flash_attention": 0, "decode_attention": 0}
    by_dtype = {}  # (kernel, dtype) -> max abs err
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        tol = TOL[dname]

        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(dt)

        for arch, (hq, hkv, hd) in {**ATTN_LAYOUTS, **TP_LAYOUTS}.items():
            for S in FLASH_SEQS:
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
                        by_dtype[("flash", dname)] = max(by_dtype.get(("flash", dname), 0.0), e)
                        n["flash_attention"] += 1
            M = 192
            for lens in DECODE_LENGTHS:
                B = len(lens)
                q, ck, cv = rnd(B, 1, hq, hd), rnd(B, M, hkv, hd), rnd(B, M, hkv, hd)
                L = torch.tensor(lens, dtype=torch.int32, device="cuda")
                o = decode_attention(q, ck, cv, L)
                qt, ckt, cvt = q[:, 0], ck.transpose(1, 2), cv.transpose(1, 2)
                r = ref.decode_attention_ref(qt, ckt, cvt, L)[:, None]
                rs = ref.decode_attention_split_ref(qt, ckt, cvt, L, chunk=CHUNK)[:, None]
                torch.cuda.synchronize()
                live = L > 0  # the plain version averages v at length 0
                e = max((o.float() - r.float())[live].abs().max().item(),
                        (o.float() - rs.float()).abs().max().item())
                if not e <= tol:
                    raise AssertionError(f"decode_attention {dname} {arch} lengths="
                                         f"{lens}: max abs err {e} > {tol}")
                if not bool((o[~live] == 0).all()):
                    raise AssertionError(f"decode_attention {dname} {arch} lengths={lens}: "
                                         "a row of length 0 is not zeros")
                err["decode_attention"] = max(err["decode_attention"], e)
                by_dtype[("decode", dname)] = max(by_dtype.get(("decode", dname), 0.0), e)
                n["decode_attention"] += 1
                for b in range(B):  # batch invariance: bitwise
                    ob = decode_attention(q[b:b + 1], ck[b:b + 1], cv[b:b + 1], L[b:b + 1])
                    if not torch.equal(ob, o[b:b + 1]):
                        raise AssertionError(
                            f"decode_attention {dname} {arch} lengths={lens}: row {b} "
                            "of the batch differs from the row decoded alone")
        # whisper-tiny's encoder: bidirectional over its 1,500 frames
        B, S, hq, hkv, hd = WHISPER_ENC
        q, k, v = rnd(B, S, hq, hd), rnd(B, S, hkv, hd), rnd(B, S, hkv, hd)
        o = flash_attention(q, k, v, causal=False)
        r = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    causal=False).transpose(1, 2)
        torch.cuda.synchronize()
        e = (o.float() - r.float()).abs().max().item()
        if not e <= tol:
            raise AssertionError(f"flash_attention {dname} whisper-tiny encoder S={S} "
                                 f"causal=False: max abs err {e} > {tol}")
        err["flash_attention"] = max(err["flash_attention"], e)
        by_dtype[("flash", dname)] = max(by_dtype.get(("flash", dname), 0.0), e)
        n["flash_attention"] += 1
    log(f"[kernels] {n} checks passed; max abs err {err}, by type "
        f"{ {f'{k} {d}': v for (k, d), v in by_dtype.items()} } "
        f"(tolerance bf16 {TOL['bfloat16']}, fp32 {TOL['float32']}; decode also against "
        f"the split-K plain version, chunk {CHUNK})")
    return err, n


def _topk_bank(torch, n, g, d=384):
    """(n, d) unit rows on the card with planted exact ties and zero rows
    (the positions that fall inside n): row 1 and rows 19,999 and 999,999
    repeat row 0; rows 40 and 63 repeat row 5; rows 2, 50-53 and
    10,000-10,003 are zero."""
    b = torch.randn(n, d, generator=g, device="cuda")
    b /= b.norm(dim=1, keepdim=True)
    for dup, src in ((1, 0), (19_999, 0), (999_999, 0), (40, 5), (63, 5)):
        if dup < n:
            b[dup] = b[src]
    for z in (2, 50, 51, 52, 53, 10_000, 10_001, 10_002, 10_003):
        if z < n:
            b[z] = 0.0
    return b


def _check_topk_result(s, i, rs, ri, k, label):
    """Kernel (s, i) (Q, k) against the plain version's top-K (K >= k) on
    the same inputs, on the host: scores within TOPK_TOL, padding where the
    plain version pads, indices equal except inside runs of near-ties
    (adjacent plain scores within TOPK_TOL), where the kernel's rows must
    be the run's rows (a subset of them where the run crosses position k),
    and bitwise-equal kernel scores in ascending row order. Returns the max
    abs score error."""
    import numpy as np

    if not (np.all((i >= 0) == (ri[:, :k] >= 0))):
        raise AssertionError(f"topk_cosine {label}: padding differs from the plain version")
    valid = ri[:, :k] >= 0
    err = float(np.abs(s - rs[:, :k])[valid].max()) if valid.any() else 0.0
    if not err <= TOPK_TOL:
        raise AssertionError(f"topk_cosine {label}: max abs score err {err} > {TOPK_TOL}")
    for qi in range(s.shape[0]):
        j = 0
        while j < k and ri[qi, j] >= 0:
            e = j + 1
            while (e < ri.shape[1] and ri[qi, e] >= 0
                   and rs[qi, e - 1] - rs[qi, e] <= TOPK_TOL):
                e += 1
            got, want = set(i[qi, j:min(e, k)].tolist()), set(ri[qi, j:e].tolist())
            if not (got == want if e <= k else got <= want):
                raise AssertionError(
                    f"topk_cosine {label} query {qi}: rows {sorted(got)} at positions "
                    f"{j}..{min(e, k) - 1}, plain version {sorted(want)}")
            j = e
        for j in range(k - 1):
            if i[qi, j + 1] >= 0 and s[qi, j] == s[qi, j + 1] and not i[qi, j] < i[qi, j + 1]:
                raise AssertionError(f"topk_cosine {label} query {qi}: exact tie not "
                                     f"lowest row first: {i[qi, j]}, {i[qi, j + 1]}")
    return err


def _topk_queries(torch, bank, g, n=130):
    """n unit queries of the bank's width; query 0 is bank row 0 and query
    1 bank row 5 (or the last row), so the planted ties are hit."""
    N, d = bank.shape
    queries = torch.randn(n, d, generator=g, device="cuda")
    queries /= queries.norm(dim=1, keepdim=True)
    queries[0] = bank[0]
    queries[1] = bank[min(5, N - 1)]
    return queries


def _topk_case(torch, queries, bank, rs, ri, Q, k, label):
    """One kernel call on the first Q queries against the plain version's
    top-K (rs, ri) of all queries (K >= min(N, k); the order is total, so
    top-k is its prefix): scores, rows and padding, and the planted ties
    of query 0 lowest row first. Returns the max abs score error."""
    import numpy as np

    from repro_torch.kernels.similarity import topk_cosine

    N, K = bank.shape[0], rs.shape[1]
    s, i = topk_cosine(queries[:Q], bank, k)
    torch.cuda.synchronize()
    s, i = s.cpu().numpy(), i.cpu().numpy()
    pad_s, pad_i = rs[:Q], ri[:Q]
    if K < k:  # N < k: the plain version pads past N
        pad_s = np.pad(pad_s, ((0, 0), (0, k - K)), constant_values=-1e30)
        pad_i = np.pad(pad_i, ((0, 0), (0, k - K)), constant_values=-1)
    err = _check_topk_result(s, i, pad_s, pad_i, k, label)
    expect = [r for r in (0, 1, 19_999, 999_999) if r < N][:k]
    if list(i[0, :len(expect)]) != expect:
        raise AssertionError(f"topk_cosine {label}: planted ties of query 0 "
                             f"came out {list(i[0, :len(expect)])}, want {expect}")
    return err


def _cuda_kernels_of(torch, fn):
    """Names of the device activities (kernels, copies, fills) that one
    call of ``fn`` runs, by torch.profiler's CUDA events; ``fn`` is called
    once before, unprofiled, to build and allocate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = []
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:
            names += [a.key] * a.count
    return names


def check_topk(torch):
    """Phase 3 (top-k): the cosine top-k kernel against its plain version
    at Q in {1, 8, 64, 130}, N in {1, 3, 64, 20,000, 1,000,000}, k in
    {1, 4, 32}, D = 384, and at D = 388 (a ragged last k-step) and 1,024 for
    Q in {1, 8, 64}, N in {64, 20,000}; the planted ties come out lowest row
    first; a query's result is bitwise equal alone, inside a batch of 64,
    and at two other split counts; one call is one CUDA kernel
    (torch.profiler) at the agent's shape and at (64, 1e6, 4); one call
    through ``ops.batch_topk`` with a host bank. Returns (max abs score
    error, checks)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.similarity import topk_cosine

    g = torch.Generator(device="cuda").manual_seed(2)
    worst, n_checks = 0.0, 0
    for N in (1, 3, 64, 20_000, 1_000_000):
        bank = _topk_bank(torch, N, g)
        queries = _topk_queries(torch, bank, g)
        # the plain version's top-K of all 130 queries; top-k of the first
        # Q queries is its prefix (the order is total)
        K = min(N, 48)
        rs, ri = (x.cpu().numpy() for x in ref.topk_cosine_ref(queries, bank, K))
        for Q in (1, 8, 64, 130):
            for k in (1, 4, 32):
                worst = max(worst, _topk_case(torch, queries, bank, rs, ri, Q, k,
                                              f"Q={Q} N={N} k={k}"))
                n_checks += 1
        if N >= 20_000:  # batch and split invariance, bitwise
            for k in (4, 32):
                s64, i64 = topk_cosine(queries[:64], bank, k)
                variants = [topk_cosine(queries[:64], bank, k, n_split=ns) for ns in (7, 1000)]
                alone = [topk_cosine(queries[j:j + 1], bank, k) for j in range(64)]
                variants.append((torch.cat([a for a, _ in alone]),
                                 torch.cat([b for _, b in alone])))
                for vs, vi in variants:
                    if not (torch.equal(vs, s64) and torch.equal(vi, i64)):
                        raise AssertionError(f"topk_cosine N={N} k={k}: result depends on "
                                             "the batch or the split count")
                n_checks += 1
        if N in TOPK_PROFILED:  # the agent's (8, 64, 1) and the scale (64, 1e6, 4)
            Q, k = TOPK_PROFILED[N]
            names = _cuda_kernels_of(torch, lambda: topk_cosine(queries[:Q], bank, k))
            if len(names) != 1 or "topk" not in names[0]:
                raise AssertionError(f"topk_cosine Q={Q} N={N} k={k}: one call ran "
                                     f"{names}, not one top-k kernel")
            n_checks += 1
        del bank
    # other widths: D = 388 ends in a k-step of 4 real dims and 4 zero ones
    for D in (388, 1024):
        for N in (64, 20_000):
            bank = _topk_bank(torch, N, g, D)
            queries = _topk_queries(torch, bank, g, 64)
            K = min(N, 48)
            rs, ri = (x.cpu().numpy() for x in ref.topk_cosine_ref(queries, bank, K))
            for Q in (1, 8, 64):
                for k in (1, 4, 32):
                    worst = max(worst, _topk_case(torch, queries, bank, rs, ri, Q, k,
                                                  f"Q={Q} N={N} k={k} D={D}"))
                    n_checks += 1
            del bank
    # the `pallas` index backend at the agent's shape: 8 padded queries
    # against the 64-row host arena, uploaded by ops.batch_topk every call
    bank = _topk_bank(torch, 64, g)
    q = torch.randn(8, 384, generator=g, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    q[0] = bank[0]
    before = topk_cosine.launches
    s, i = ops.batch_topk(q, bank.cpu().numpy(), k=1)
    if topk_cosine.launches != before + 1:
        raise AssertionError("topk_cosine: ops.batch_topk on a host bank did not launch")
    rs, ri = (x.cpu().numpy() for x in ref.topk_cosine_ref(q, bank, 8))
    worst = max(worst, _check_topk_result(s.cpu().numpy(), i.cpu().numpy(), rs, ri, 1,
                                          "ops.batch_topk host bank Q=8 N=64 k=1"))
    if int(i[0, 0]) != 0:
        raise AssertionError(f"topk_cosine ops.batch_topk: query 0 came out {int(i[0, 0])}")
    n_checks += 1
    q = torch.zeros(0, 384, device="cuda")
    before = topk_cosine.launches
    s, i = topk_cosine(q, torch.zeros(5, 384, device="cuda"), 4)
    if topk_cosine.launches != before or s.shape != (0, 4):
        raise AssertionError("topk_cosine: Q = 0 must return without a launch")
    try:
        topk_cosine(torch.zeros(1, 384, device="cuda"), torch.zeros(5, 384, device="cuda"), 33)
    except ValueError:
        pass
    else:
        raise AssertionError("topk_cosine: k = 33 must raise")
    log(f"[kernels] topk_cosine: {n_checks} checks passed; max abs score err {worst:.3e} "
        f"(tolerance {TOPK_TOL})")
    return worst, n_checks


def time_topk(torch):
    """Phase 3b (top-k): kernel, plain version and library call
    (``torch.topk(q @ bank.T, k)``) at the agent path's shape (Q = 8 padded,
    the 64-row arena, k = 1) and at the index's scale shapes; then the
    ``pallas`` backend's call at the agent's shape, ``ops.batch_topk`` with
    the bank on the host, whose upload the three versions all pay (the
    bound counts the card's memory only). The bound is the larger of the
    bytes over the card's memory rate and the kernel's three TF32 products
    a multiply-add over the tensor cores' TF32 peak."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.similarity import topk_cosine

    g = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for Q, N, k in ((8, 64, 1), (8, 20_000, 1), (64, 20_000, 4), (8, 1_000_000, 1),
                    (64, 1_000_000, 4)):
        bank = _topk_bank(torch, N, g)
        q = torch.randn(Q, 384, generator=g, device="cuda")
        q /= q.norm(dim=1, keepdim=True)
        nbytes = 4 * (Q * 384 + N * 384) + 8 * Q * k
        bms, by = bound(nbytes, TOPK_PRODUCTS * 2 * Q * N * 384, PEAK_TF32_FLOPS)
        rows.append(_timed(
            torch, "topk_cosine", "index", f"Q={Q} N={N} k={k} D=384 fp32",
            lambda: topk_cosine(q, bank, k),
            lambda: ref.topk_cosine_ref(q, bank, k),
            lambda: torch.topk(q @ bank.T, k, dim=1),
            bms, by))
        del bank
    Q, N, k = 8, 64, 1
    host = _topk_bank(torch, N, g).cpu().numpy()
    q = torch.randn(Q, 384, generator=g, device="cuda")
    q /= q.norm(dim=1, keepdim=True)
    bms, by = bound(4 * (Q * 384 + N * 384) + 8 * Q * k, TOPK_PRODUCTS * 2 * Q * N * 384,
                    PEAK_TF32_FLOPS)
    rows.append(_timed(
        torch, "topk_cosine", "index, host bank", f"Q={Q} N={N} k={k} D=384 fp32",
        lambda: ops.batch_topk(q, host, k=k),
        lambda: ref.topk_cosine_ref(q, torch.from_numpy(host).to("cuda"), k),
        lambda: torch.topk(q @ torch.from_numpy(host).to("cuda").T, k, dim=1),
        bms, by))
    for r in rows:
        log("[timing] " + json.dumps(r))
    return rows


def _timed(torch, kernel, arch, shape, fn, plain, library, bound_ms, bound_by):
    """Times of the kernel, its plain version and (where one PyTorch call
    computes the same function; else ``library`` is None) the library."""
    ms, call_ms = time_ms(torch, fn)
    plain_ms, plain_call_ms = time_ms(torch, plain)
    library_ms, library_call_ms = time_ms(torch, library) if library else (None, None)
    return {"kernel": kernel, "arch": arch, "shape": shape, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "library_call_ms": library_call_ms}


def time_kernels(torch):
    """Phase 3b: kernel, plain version and library call at the serving
    path's shapes (B=1, bf16; prefill S=152 — the longest prompt the
    backend sends — and decode M=192 at length 168), at every layout of
    ATTN_LAYOUTS (the deployment's, zamba2's hd 80, the other families'),
    flash bidirectional at whisper-tiny's encoder; plus one flash row off
    the path, at nemotron's layout and S = LONG_S, marked ``off_path``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(1)
    dt, esz = torch.bfloat16, 2
    rows = []
    for arch, (hq, hkv, hd) in ATTN_LAYOUTS.items():
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
    # whisper-tiny's encoder: bidirectional, every (query, key) pair
    B, S, hq, hkv, hd = WHISPER_ENC
    q = torch.randn(B, S, hq, hd, generator=g, device="cuda").to(dt)
    k = torch.randn(B, S, hkv, hd, generator=g, device="cuda").to(dt)
    v = torch.randn(B, S, hkv, hd, generator=g, device="cuda").to(dt)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bms, by = bound(esz * B * S * hd * (2 * hq + 2 * hkv), 4 * B * hq * hd * S * S,
                    PEAK_BF16_FLOPS)
    rows.append(_timed(
        torch, "flash_attention", "whisper-tiny",
        f"B={B} S={S} Hq={hq} Hkv={hkv} hd={hd} bf16 causal=False (encoder)",
        lambda: flash_attention(q, k, v, causal=False),
        lambda: ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=False),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True),
        bms, by))
    # off the path: one prefill at nemotron's layout long enough that the
    # tensor-core work, not latency, bounds it (the ground for or against a
    # wgmma/TMA flash kernel)
    hq, hkv, hd = LAYOUTS["nemotron-4-15b"]
    B, S = 1, LONG_S
    q = torch.randn(B, S, hq, hd, generator=g, device="cuda").to(dt)
    k = torch.randn(B, S, hkv, hd, generator=g, device="cuda").to(dt)
    v = torch.randn(B, S, hkv, hd, generator=g, device="cuda").to(dt)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bms, by = bound(esz * B * S * hd * (2 * hq + 2 * hkv),
                    4 * B * hq * hd * S * (S + 1) / 2, PEAK_BF16_FLOPS)
    row = _timed(
        torch, "flash_attention", "nemotron-4-15b",
        f"B={B} S={S} Hq={hq} Hkv={hkv} hd={hd} bf16 (off the path: long prefill)",
        lambda: flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
        bms, by)
    row["off_path"] = True
    rows.append(row)
    for r in rows:
        log("[timing] " + json.dumps(r))
    return rows


def _page_table(torch, B, P, npages, ps, lengths, seed):
    """(B, P) int32 on the card: each sequence's pages at distinct, permuted
    pool rows, -1 past its last page."""
    import numpy as np

    rng = np.random.RandomState(seed)
    table = np.full((B, P), -1, np.int32)
    for b, ln in enumerate(lengths):
        n = -(-ln // ps)
        table[b, :n] = rng.choice(npages, size=n, replace=False)
    return torch.from_numpy(table).to("cuda")


def _gather_pages(torch, pages, table):
    """The (B, P * ps, Hkv, hd) dense cache of the pages in table order,
    entries below 0 clamped to row 0 (as the kernel clamps them)."""
    B, P = table.shape
    rows = table.clamp(min=0).long().reshape(-1)
    return pages.index_select(0, rows).reshape(B, P * pages.shape[1], *pages.shape[2:])


def check_paged(torch):
    """Phase 3 (paged): the paged decode kernel against its plain version
    at the three head layouts (hd 128) and the prefix families' (granite
    hd 64, qwen2-vl G = 7; B = 4; ps in {8, 16, 32, 64}; lengths
    1, a partial page, two full pages and the full table) and at the
    hd 64 / hd 32 shapes of tests/test_kernels.py, in bf16 and fp32, on
    permuted pool rows with -1 past the end. Each result is also bitwise
    equal to the dense decode kernel on the pages gathered in table order,
    and each row bitwise equal to that row decoded alone. Returns (max abs
    error, checks)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention

    cases = []  # (label, B, Hq, Hkv, hd, ps, npages, P, lengths)
    for arch, (hq, hkv, hd) in {**LAYOUTS, **PAGED_FAMILY_LAYOUTS}.items():
        for ps in (8, 16, 32, 64):
            P = -(-192 // ps)
            cases.append((arch, 4, hq, hkv, hd, ps, 4 * P + 3, P, (1, ps + 3, 2 * ps, P * ps)))
    cases += [("hd64", 3, 8, 2, 64, 64, 16, 4, (200, 100, 256)),
              ("hd32", 2, 4, 4, 32, 16, 32, 8, (128, 7)),
              ("hd64 mqa", 1, 4, 1, 64, 32, 8, 2, (33,))]
    g = torch.Generator(device="cuda").manual_seed(4)
    worst, n = 0.0, 0
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for i, (label, B, hq, hkv, hd, ps, npages, P, lens) in enumerate(cases):
            q = torch.randn(B, 1, hq, hd, generator=g, device="cuda").to(dt)
            kp = torch.randn(npages, ps, hkv, hd, generator=g, device="cuda").to(dt)
            vp = torch.randn(npages, ps, hkv, hd, generator=g, device="cuda").to(dt)
            table = _page_table(torch, B, P, npages, ps, lens, seed=i)
            L = torch.tensor(lens, dtype=torch.int32, device="cuda")
            tag = f"paged_decode_attention {dname} {label} ps={ps} lengths={lens}"
            o = paged_decode_attention(q, kp, vp, table, L)
            r = ref.paged_attention_ref(q[:, 0], kp, vp, table, L)[:, None]
            torch.cuda.synchronize()
            e = (o.float() - r.float()).abs().max().item()
            if not e <= TOL[dname]:
                raise AssertionError(f"{tag}: max abs err {e} > {TOL[dname]}")
            worst = max(worst, e)
            od = decode_attention(q, _gather_pages(torch, kp, table),
                                  _gather_pages(torch, vp, table), L)
            if not torch.equal(o, od):
                raise AssertionError(f"{tag}: not bitwise equal to decode_attention on "
                                     "the cache gathered in table order")
            for b in range(B):
                ob = paged_decode_attention(q[b:b + 1], kp, vp, table[b:b + 1], L[b:b + 1])
                if not torch.equal(ob, o[b:b + 1]):
                    raise AssertionError(f"{tag}: row {b} of the batch differs from "
                                         "the row decoded alone")
            n += 1
    pb = torch.zeros(2, 8, 1, 48, device="cuda")
    t1 = torch.zeros(1, 1, dtype=torch.int32, device="cuda")
    l1 = torch.ones(1, dtype=torch.int32, device="cuda")
    for call in (lambda: paged_decode_attention(torch.zeros(1, 1, 4, 48, device="cuda"),
                                                pb, pb, t1, l1),
                 lambda: ops.paged_decode_attention_op(q, kp, vp, table, L, logit_softcap=5.0)):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError("paged_decode_attention: head_dim 48 and a nonzero softcap "
                             "must raise")
    log(f"[kernels] paged_decode_attention: {n} checks passed (each also bitwise equal "
        f"to decode_attention and batch-invariant); max abs err {worst:.3e} "
        f"(tolerance bf16 {TOL['bfloat16']}, fp32 {TOL['float32']})")
    return worst, n


def time_paged(torch):
    """Phase 3b (paged): kernel, plain version and a library yardstick at
    the prefix path's shape: B = 4, length 168, page size 32, bf16, a
    64-page pool, at nemotron's layout (the kernel line's row) and at the
    prefix families' (granite hd 64, qwen2-vl G = 7). No single PyTorch call
    computes paged attention; the yardstick is two calls, an
    ``index_select`` gather of the pages and
    ``F.scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention

    B, ln, ps, npages = 4, 168, 32, 64
    P = -(-ln // ps)
    g = torch.Generator(device="cuda").manual_seed(5)
    dt, esz = torch.bfloat16, 2
    out = []
    layouts = {"nemotron-4-15b": LAYOUTS["nemotron-4-15b"], **PAGED_FAMILY_LAYOUTS}
    for arch, (hq, hkv, hd) in layouts.items():
        q = torch.randn(B, 1, hq, hd, generator=g, device="cuda").to(dt)
        kp = torch.randn(npages, ps, hkv, hd, generator=g, device="cuda").to(dt)
        vp = torch.randn(npages, ps, hkv, hd, generator=g, device="cuda").to(dt)
        table = _page_table(torch, B, P, npages, ps, (ln,) * B, seed=99)
        L = torch.full((B,), ln, dtype=torch.int32, device="cuda")
        rows = table.clamp(min=0).long().reshape(-1)
        qt = q.transpose(1, 2)
        mask = (torch.arange(P * ps, device="cuda")[None, :] < L[:, None])[:, None, None, :]

        def library():  # timed within this iteration, so its free names are this layout's
            k = kp.index_select(0, rows).view(B, P * ps, hkv, hd).transpose(1, 2)
            v = vp.index_select(0, rows).view(B, P * ps, hkv, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(qt, k, v, attn_mask=mask, enable_gqa=True)

        nbytes = esz * B * hd * (2 * hq + 2 * hkv * ln) + 4 * B * (P + 1)
        bms, by = bound(nbytes, 4 * B * hq * hd * ln, PEAK_BF16_FLOPS)
        row = _timed(
            torch, "paged_decode_attention", arch,
            f"B={B} len={ln} ps={ps} P={P} pool={npages} Hq={hq} Hkv={hkv} hd={hd} bf16",
            lambda: paged_decode_attention(q, kp, vp, table, L),
            lambda: ref.paged_attention_ref(q[:, 0], kp, vp, table, L),
            library, bms, by)
        row["library"] = "index_select gather + F.scaled_dot_product_attention (two calls)"
        # the dense decode kernel on the same pages gathered, at the same B
        kd, vd = _gather_pages(torch, kp, table), _gather_pages(torch, vp, table)
        row["dense_kernel_ms"], row["dense_kernel_call_ms"] = time_ms(
            torch, lambda: decode_attention(q, kd, vd, L))
        log("[timing] " + json.dumps(row))
        out.append(row)
    return out


def _scan_close(name, got, want, label):
    """Kernel output against the plain version's, at SCAN_TOL; returns the
    max abs error."""
    atol, rtol = SCAN_TOL[name]
    err = (got - want).abs()
    lim = atol * max(1.0, want.abs().max().item()) + rtol * want.abs()
    if not bool((err <= lim).all()):
        raise AssertionError(f"{name} {label}: max abs err {err.max().item()} over the "
                             f"tolerance (atol {atol} x max(1, max|plain|) + rtol {rtol} "
                             "x |plain|)")
    return err.max().item()


def _wkv6_inputs(torch, g, B, S, H, N, draw):
    """r, k, v, w_log, u on the card in float32. ``model``: as rwkv6-3b
    draws them at full width (r, k, v ~ N(0, 1): 0.02-scale weights on
    layer-normed inputs of width 2,560; log decay -exp(-4.6 + lora) with
    lora ~ 0.037 N(0, 1), clipped to [-8, -1e-5]; bonus 0.1 N(0, 1)).
    ``sweep``: as tests/test_kernels.py::test_wkv6_sweep, with r, k, v
    transposed views of (B, H, S, N) tensors, so strides are exercised."""
    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    if draw == "model":
        r, k, v = rnd(B, S, H, N), rnd(B, S, H, N), rnd(B, S, H, N)
        w = (-torch.exp(-4.6 + 0.037 * rnd(B, S, H, N))).clamp(-8.0, -1e-5)
        return r, k, v, w, 0.1 * rnd(H, N)
    r, k, v = (0.5 * rnd(B, H, S, N).transpose(1, 2) for _ in range(3))
    return r, k, v, -torch.exp(0.5 * rnd(B, S, H, N) - 2.0), 0.3 * rnd(H, N)


def _ssd_inputs(torch, g, B, S, H, P, Ns, draw, G=1):
    """x, dt, A_log, B_, C_, D on the card in float32; B_ and C_ (B, S, Ns)
    with one group, else (B, S, G, Ns). ``model``: as zamba2-2.7b and
    Nemotron-H draw them at full width (x, B_, C_ = silu(0.2 N(0, 1)), the
    conv's output; dt = softplus(N(0, 1) - 2); A_log 0, D 1), with x, B_
    and C_ strided views of one (B, S, H P + 2 G Ns) tensor, as the model
    slices its conv output. ``sweep``: as tests/test_kernels.py::
    test_ssd_sweep (x, B_, C_ 0.5 N(0, 1), dt = softplus(N(0, 1)))."""
    import torch.nn.functional as F

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    A_log = torch.zeros(H, device="cuda")
    D = torch.ones(H, device="cuda")
    bc = (Ns,) if G == 1 else (G, Ns)
    if draw == "model":
        n = G * Ns
        conv = F.silu(0.2 * rnd(B, S, H * P + 2 * n))
        x = conv[..., :H * P].reshape(B, S, H, P)
        return (x, F.softplus(rnd(B, S, H) - 2.0), A_log,
                conv[..., H * P:H * P + n].unflatten(-1, bc),
                conv[..., H * P + n:].unflatten(-1, bc), D)
    return (0.5 * rnd(B, S, H, P), F.softplus(rnd(B, S, H)), A_log, 0.5 * rnd(B, S, *bc),
            0.5 * rnd(B, S, *bc), D)


def check_scans(torch):
    """Phase 3 (scans): the wkv6 and SSD kernels against their plain
    (chunked) versions and the sequential oracles, y and final state:
    at rwkv6-3b's (H 40, N 64) and zamba2's (H 80, P 64, Ns 64) layouts
    and Nemotron-H's (H 256, P 64, B and C in 8 groups, Ns 128 and 256),
    S in SCAN_SEQS, B in {1, 4}, decays drawn as the model draws them
    (chunk 128, the model's) and as the JAX sweeps do (wkv6 chunk 128;
    ssd chunk 64: at 128 the sweep's decays overflow the chunked form,
    see ROADMAP section 3); plus the sweeps' own shapes and chunks, and
    the other layouts the wrappers take (SCAN_EXTRA_*, chunk 64); bf16
    and fp32 inputs. Unsupported head sizes and rows not 16-byte aligned
    must raise. Returns ({name: max abs error}, {name: checks})."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6 import wkv6
    from repro_torch.kernels.ssd import ssd

    g = torch.Generator(device="cuda").manual_seed(6)
    H, N = WKV6_LAYOUT
    wk_cases = [(B, S, H, N, draw, MODEL_CHUNK) for draw in ("model", "sweep")
                for S in SCAN_SEQS for B in (1, 4)]
    wk_cases += [(2, S, 3, n, "sweep", c) for S, c in ((64, 16), (128, 32), (96, 32))
                 for n in (16, 64)]
    wk_cases += [(2, S, 3, n, "sweep", 64) for n in SCAN_EXTRA_WKV6 for S in SCAN_EXTRA_SEQS]
    H, P, Ns = SSD_LAYOUT
    sd_cases = [(B, S, H, P, Ns, 1, draw, MODEL_CHUNK if draw == "model" else 64)
                for draw in ("model", "sweep") for S in SCAN_SEQS for B in (1, 4)]
    sd_cases += [(2, 64, 3, 32, 16, 1, "sweep", 16), (2, 128, 3, 64, 64, 1, "sweep", 64)]
    sd_cases += [(2, S, 3, p, ns, 1, "sweep", 64) for p, ns in SCAN_EXTRA_SSD
                 for S in SCAN_EXTRA_SEQS]
    H, P, G = SSD_GROUPED_LAYOUT
    sd_cases += [(B, S, H, P, ns, G, draw, MODEL_CHUNK if draw == "model" else 64)
                 for ns in SSD_GROUPED_NS for draw in ("model", "sweep") for S in SCAN_SEQS
                 for B in (1, 4)]
    err = {"wkv6": 0.0, "ssd": 0.0}
    n = {"wkv6": 0, "ssd": 0}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for B, S, H, N, draw, chunk in wk_cases:
            r, k, v, w, u = _wkv6_inputs(torch, g, B, S, H, N, draw)
            r, k, v = r.to(dt), k.to(dt), v.to(dt)
            y, st = wkv6(r, k, v, w, u)
            for which, (yr, sr) in (("plain", ref.wkv6_chunked_ref(r, k, v, w, u, chunk=chunk)),
                                    ("oracle", ref.rwkv6_ref(r, k, v, w, u))):
                label = f"{dname} {draw} B={B} S={S} H={H} N={N} chunk={chunk} vs {which}"
                e = max(_scan_close("wkv6", y, yr, "y " + label),
                        _scan_close("wkv6", st, sr, "state " + label))
                err["wkv6"] = max(err["wkv6"], e)
            n["wkv6"] += 1
        for B, S, H, P, Ns, G, draw, chunk in sd_cases:
            x, dtv, A_log, Bm, Cm, D = _ssd_inputs(torch, g, B, S, H, P, Ns, draw, G)
            x, Bm, Cm = x.to(dt), Bm.to(dt), Cm.to(dt)
            y, st = ssd(x, dtv, A_log, Bm, Cm, D)
            for which, (yr, sr) in (
                    ("plain", ref.ssd_chunked_ref(x, dtv, A_log, Bm, Cm, D, chunk=chunk)),
                    ("oracle", ref.ssd_ref(x, dtv, A_log, Bm, Cm, D))):
                label = (f"{dname} {draw} B={B} S={S} H={H} P={P} Ns={Ns} G={G} chunk={chunk} "
                         f"vs {which}")
                e = max(_scan_close("ssd", y, yr, "y " + label),
                        _scan_close("ssd", st, sr, "state " + label))
                err["ssd"] = max(err["ssd"], e)
            n["ssd"] += 1
    torch.cuda.synchronize()

    def unaligned(t):  # t's values one element off a 16-byte boundary
        out = torch.empty(*t.shape[:-1], t.shape[-1] + 1, dtype=t.dtype, device=t.device)
        out = out.narrow(-1, 1, t.shape[-1])
        out.copy_(t)
        return out

    for what, call in (
            ("an unsupported head size", lambda: wkv6(*(t[..., :24] for t in (r, k, v, w)),
                                                      u[:, :24])),
            ("an unsupported head size", lambda: ssd(x[..., :24], dtv, A_log, Bm, Cm, D)),
            ("unaligned rows", lambda: wkv6(r, unaligned(k), v, w, u)),
            ("unaligned rows", lambda: ssd(x, dtv, A_log, unaligned(Bm), Cm, D))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"wkv6 / ssd: {what} must raise")
    log(f"[kernels] scans: {n} checks passed (each against the chunked plain version and "
        f"the sequential oracle, y and state); max abs err {err} (tolerance {SCAN_TOL}: "
        "atol x max(1, max|plain|) + rtol x |plain|)")
    return err, n


def _ssd_step_inputs(torch, g, B, H, P, Ns, G):
    """One decode step's x, dt, A_log, B_, C_, D as the model draws them
    (``_ssd_inputs``' model draw at S 1: x, B_ and C_ strided views of one
    conv output; B_/C_ (B, Ns) with one group) and a state N(0, 1)."""
    x, dtv, A_log, Bm, Cm, D = _ssd_inputs(torch, g, B, 1, H, P, Ns, "model", G)
    state = torch.randn((B, H, P, Ns), generator=g, device="cuda")
    return x[:, 0], dtv[:, 0], A_log, Bm[:, 0], Cm[:, 0], D, state


def check_ssd_step(torch):
    """Phase 3 (decode step): the ssd_step kernel against the plain step
    (``models.mamba.ssd_step``), y and state, two steps in place from a
    random state, at zamba2's and Nemotron-H's layouts and the other
    (P, Ns) the wrappers take, B in SSD_STEP_BATCHES, bf16 and fp32 inputs;
    the state must be the tensor given, in its own storage. An unsupported
    head size and a state not contiguous must raise. Returns (max abs
    error, checks)."""
    from repro_torch.kernels.ssd import SHAPES
    from repro_torch.kernels.ssd_step import ssd_step
    from repro_torch.models.mamba import ssd_step as plain

    g = torch.Generator(device="cuda").manual_seed(9)
    H, P, Ns = SSD_LAYOUT
    layouts = [(H, P, Ns, 1)]
    H, P, G = SSD_GROUPED_LAYOUT
    layouts += [(H, P, ns, G) for ns in SSD_GROUPED_NS]
    layouts += [(3, p, ns, 1) for p, ns in SHAPES if (p, ns) != SSD_LAYOUT[1:]]
    err, n = 0.0, 0
    for dname in ("bfloat16", "float32"):
        for H, P, Ns, G in layouts:
            for B in SSD_STEP_BATCHES:
                x, dtv, A_log, Bm, Cm, D, state = _ssd_step_inputs(torch, g, B, H, P, Ns, G)
                x, Bm, Cm = (t.to(getattr(torch, dname)) for t in (x, Bm, Cm))
                ptr, want = state.data_ptr(), state.clone()
                for step in range(2):
                    yr, want = plain(x, dtv, A_log, Bm, Cm, D, want)
                    y, st = ssd_step(x, dtv, A_log, Bm, Cm, D, state)
                    if st is not state or state.data_ptr() != ptr:
                        raise AssertionError("ssd_step: the state was not updated in place")
                    label = f"{dname} B={B} H={H} P={P} Ns={Ns} G={G} step {step}"
                    err = max(err, _scan_close("ssd_step", y, yr, "y " + label),
                              _scan_close("ssd_step", state, want, "state " + label))
                n += 1
    torch.cuda.synchronize()
    for what, call in (
            ("an unsupported head size",
             lambda: ssd_step(x[..., :24], dtv, A_log, Bm, Cm, D, state[:, :, :24])),
            ("a state not contiguous",
             lambda: ssd_step(x, dtv, A_log, Bm, Cm, D,
                              state.transpose(0, 1).contiguous().transpose(0, 1)))):
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"ssd_step: {what} must raise")
    log(f"[kernels] ssd_step: {n} checks passed (two steps in place against the plain step, y "
        f"and state); max abs err {err} (tolerance {SCAN_TOL['ssd_step']})")
    return err, n


def _conv_inputs(torch, g, B, S, width, col, CH, dtype):
    """xc the columns [col, col + CH) of an in_proj output (B, S, width)
    drawn N(0, 1) in ``dtype``; w 0.25 + 0.1 N(0, 1) (CONV_TAPS, CH) and b
    0.1 N(0, 1) (CH,) in fp32."""
    xc = torch.randn((B, S, width), generator=g, device="cuda").to(dtype)[..., col:col + CH]
    w = 0.25 + 0.1 * torch.randn((CONV_TAPS, CH), generator=g, device="cuda")
    return xc, w, 0.1 * torch.randn((CH,), generator=g, device="cuda")


def check_causal_conv(torch):
    """Phase 3 (prefill conv): the causal_conv kernel against the plain conv
    (``ref.causal_conv_ref``) at each layout of CONV_LAYOUTS, with and
    without a carry drawn N(0, 1), in bf16 and fp32: y and the new carry
    bit for bit, one launch a call. Three taps and channels not a multiple
    of 8 must raise. Returns (max abs error, checks)."""
    from repro_torch.kernels.causal_conv import causal_conv
    from repro_torch.kernels.ref import causal_conv_ref

    g = torch.Generator(device="cuda").manual_seed(10)
    err, n = 0.0, 0
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for arch, (B, S, width, col, CH) in CONV_LAYOUTS.items():
            xc, w, b = _conv_inputs(torch, g, B, S, width, col, CH, dt)
            for carry in (False, True):
                prev = (torch.randn((B, CONV_TAPS - 1, CH), generator=g, device="cuda").to(dt)
                        if carry else None)
                label = f"{arch} {dname} B={B} S={S} CH={CH}" + (" carry" if carry else "")
                launches = causal_conv.launches
                y, c = causal_conv(xc, w, b, prev)
                if causal_conv.launches != launches + 1:
                    raise AssertionError(f"causal_conv: {label}: "
                                         f"{causal_conv.launches - launches} launches")
                want, want_c = causal_conv_ref(xc, w, b, prev)
                err = max(err, (y.float() - want.float()).abs().max().item(),
                          (c.float() - want_c.float()).abs().max().item())
                if not (torch.equal(y, want) and torch.equal(c, want_c)):
                    raise AssertionError(f"causal_conv: {label}: not the plain conv bit for "
                                         f"bit (max abs err {err})")
                n += 1
            del xc, y, want
    xc, w, b = torch.zeros((1, 4, 16), device="cuda"), w[:, :16], b[:16]
    for what, args in (("three taps", (xc, w[:3], b)),
                       ("channels not a multiple of 8", (xc[..., :12], w[:, :12], b[:12]))):
        try:
            causal_conv(*args)
        except ValueError:
            continue
        raise AssertionError(f"causal_conv: {what} must raise")
    torch.cuda.synchronize()
    log(f"[kernels] causal_conv: {n} checks passed (y and carry bit for bit against the plain "
        f"conv); max abs err {err}")
    return err, n


def time_scans(torch):
    """Phase 3b (scans): kernel and plain (chunked, chunk 128) version at
    rwkv6-3b's and zamba2's layouts, bf16 inputs drawn as the model draws
    them, at each (B, S) of SCAN_TIMED: the served prefill (B = 1, S = 152)
    first, then, marked ``off_path``, B = 4 and S = LONG_S; and ssd at
    Nemotron-H-47B's layout (Ns 256) and the nemotron-h-47b.plan_miss
    cell's wave (SSD_CELL_TIMED), whose bound_ms the benchmark's
    ``ssd_scan_roofline`` does not share (that counts the least any scan
    needs: 4 P Ns a step at the bf16 peak, y in bf16). No single
    PyTorch call computes either recurrence, so there is no library time.
    Bound: the larger of the bytes (each input read once, y and the state
    written once) over 3.35 TB/s and the fp32 operations over 67 TFLOP/s
    (per step and head: wkv6 5 N^2 + 5 N — the state update 3 N^2, y 2 N^2,
    the bonus term 5 N; ssd 5 P Ns + 3 P)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6 import wkv6
    from repro_torch.kernels.ssd import ssd

    g = torch.Generator(device="cuda").manual_seed(8)
    dt = torch.bfloat16
    rows = []
    for B, S in SCAN_TIMED:
        H, N = WKV6_LAYOUT
        r, k, v, w, u = _wkv6_inputs(torch, g, B, S, H, N, "model")
        r, k, v = r.to(dt), k.to(dt), v.to(dt)
        nbytes = 2 * 3 * B * S * H * N + 4 * B * S * H * N + 4 * H * N + 4 * B * S * H * N \
            + 4 * B * H * N * N
        bms, by = bound(nbytes, B * H * S * (5 * N * N + 5 * N), PEAK_FP32_FLOPS)
        rows.append(_timed(torch, "wkv6", "rwkv6-3b",
                           f"B={B} S={S} H={H} N={N} bf16 in, fp32 out",
                           lambda: wkv6(r, k, v, w, u),
                           lambda: ref.wkv6_chunked_ref(r, k, v, w, u, chunk=MODEL_CHUNK),
                           None, bms, by))
        H, P, Ns = SSD_LAYOUT
        x, dtv, A_log, Bm, Cm, D = _ssd_inputs(torch, g, B, S, H, P, Ns, "model")
        x, Bm, Cm = x.to(dt), Bm.to(dt), Cm.to(dt)
        nbytes = 2 * B * S * H * P + 4 * B * S * H + 2 * 2 * B * S * Ns + 2 * 4 * H \
            + 4 * B * S * H * P + 4 * B * H * P * Ns
        bms, by = bound(nbytes, B * H * S * (5 * P * Ns + 3 * P), PEAK_FP32_FLOPS)
        rows.append(_timed(torch, "ssd", "zamba2-2.7b",
                           f"B={B} S={S} H={H} P={P} Ns={Ns} bf16 in, fp32 out",
                           lambda: ssd(x, dtv, A_log, Bm, Cm, D),
                           lambda: ref.ssd_chunked_ref(x, dtv, A_log, Bm, Cm, D,
                                                       chunk=MODEL_CHUNK),
                           None, bms, by))
        for row in rows[-2:]:
            row["library"] = "none: no single PyTorch call computes the recurrence"
            if (B, S) != SCAN_TIMED[0]:
                row["off_path"] = True
            log("[timing] " + json.dumps(row))
    B, S = SSD_CELL_TIMED
    H, P, G = SSD_GROUPED_LAYOUT
    Ns = max(SSD_GROUPED_NS)
    x, dtv, A_log, Bm, Cm, D = _ssd_inputs(torch, g, B, S, H, P, Ns, "model", G)
    x, Bm, Cm = x.to(dt), Bm.to(dt), Cm.to(dt)
    nbytes = 2 * B * S * H * P + 4 * B * S * H + 2 * 2 * B * S * G * Ns + 2 * 4 * H \
        + 4 * B * S * H * P + 4 * B * H * P * Ns
    bms, by = bound(nbytes, B * H * S * (5 * P * Ns + 3 * P), PEAK_FP32_FLOPS)
    row = _timed(torch, "ssd", "nemotron-h-47b",
                 f"B={B} S={S} H={H} P={P} Ns={Ns} G={G} bf16 in, fp32 out",
                 lambda: ssd(x, dtv, A_log, Bm, Cm, D),
                 lambda: ref.ssd_chunked_ref(x, dtv, A_log, Bm, Cm, D, chunk=MODEL_CHUNK),
                 None, bms, by)
    row["library"] = "none: no single PyTorch call computes the recurrence"
    rows.append(row)
    log("[timing] " + json.dumps(row))
    rows.append(time_ssd_step(torch, g))
    rows.append(time_causal_conv(torch, g))
    return rows


def time_ssd_step(torch, g):
    """The decode step's kernel against the plain step at the
    nemotron-h-47b.plan_miss cell's decode (B SSD_STEP_CELL_B, Nemotron-H's
    layout at Ns 256, bf16 x/B/C), one Mamba-2 layer. Bound: the bytes, the
    fp32 state read and written once (2 x 268 MB) with x, dt, B, C, A_log,
    D read and y written once, over 3.35 TB/s; its 4 P Ns + 3 P operations a
    head at 67 TFLOP/s take a tenth of that. The kernel must reach
    SSD_STEP_MIN_SHARE of the bound."""
    from repro_torch.kernels.ssd_step import ssd_step
    from repro_torch.models.mamba import ssd_step as plain

    B = SSD_STEP_CELL_B
    H, P, G = SSD_GROUPED_LAYOUT
    Ns = max(SSD_GROUPED_NS)
    x, dtv, A_log, Bm, Cm, D, state = _ssd_step_inputs(torch, g, B, H, P, Ns, G)
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    nbytes = 2 * 4 * B * H * P * Ns + 2 * B * H * P + 4 * B * H + 2 * 2 * B * G * Ns \
        + 2 * 4 * H + 4 * B * H * P
    bms, by = bound(nbytes, B * H * (4 * P * Ns + 3 * P), PEAK_FP32_FLOPS)
    row = _timed(torch, "ssd_step", "nemotron-h-47b",
                 f"B={B} H={H} P={P} Ns={Ns} G={G} bf16 in, fp32 state in place",
                 lambda: ssd_step(x, dtv, A_log, Bm, Cm, D, state),
                 lambda: plain(x, dtv, A_log, Bm, Cm, D, state), None, bms, by)
    row["library"] = "none: no single PyTorch call computes the step"
    row["bound_share"] = bms / row["ms"]
    log("[timing] " + json.dumps(row))
    if row["bound_share"] < SSD_STEP_MIN_SHARE:
        raise AssertionError(f"ssd_step: {row['ms']:.4f} ms at the cell's decode, "
                             f"{row['bound_share']:.1%} of its bound {bms:.4f} ms (needs "
                             f"{SSD_STEP_MIN_SHARE:.0%})")
    return row


def time_causal_conv(torch, g):
    """The prefill conv's kernel against the plain conv at the
    nemotron-h-47b.plan_miss cell's prefill wave (CONV_LAYOUTS'
    Nemotron-H-47B: B 16, S 1,549, CH 20,480 of a 37,120-wide bf16 in_proj
    output), one Mamba-2 layer. Bound: the bytes, xc read and y written
    once in bf16 (2 x 1.0 GB), the taps and bias read and the carry
    written, over 3.35 TB/s; its ~12 fp32 operations a value (4 products,
    4 sums, exp, 1 + e, the division) at 67 TFLOP/s take a seventh of that.
    The kernel must reach CAUSAL_CONV_MIN_SHARE of the bound."""
    from repro_torch.kernels.causal_conv import causal_conv
    from repro_torch.kernels.ref import causal_conv_ref

    B, S, width, col, CH = CONV_LAYOUTS["nemotron-h-47b"]
    K = CONV_TAPS
    xc, w, b = _conv_inputs(torch, g, B, S, width, col, CH, torch.bfloat16)
    nbytes = 2 * 2 * B * S * CH + 4 * (K + 1) * CH + 2 * B * (K - 1) * CH
    bms, by = bound(nbytes, 12 * B * S * CH, PEAK_FP32_FLOPS)
    row = _timed(torch, "causal_conv", "nemotron-h-47b",
                 f"B={B} S={S} CH={CH} of a {width}-wide bf16 in_proj output, no carry",
                 lambda: causal_conv(xc, w, b), lambda: causal_conv_ref(xc, w, b), None,
                 bms, by)
    row["library"] = "none: no single PyTorch call computes the conv, its bias and SiLU"
    row["bound_share"] = bms / row["ms"]
    log("[timing] " + json.dumps(row))
    if row["bound_share"] < CAUSAL_CONV_MIN_SHARE:
        raise AssertionError(f"causal_conv: {row['ms']:.4f} ms at the cell's prefill, "
                             f"{row['bound_share']:.1%} of its bound {bms:.4f} ms (needs "
                             f"{CAUSAL_CONV_MIN_SHARE:.0%})")
    return row


def _model_check_config(full):
    """The config phase 4 checks for a published one: 2 layers (the hybrid:
    one group of ``attn_every``; whisper-tiny: full depth), vocabulary
    50,304, fp32; kimi-k2 with MODEL_KIMI_EXPERTS experts."""
    kw = dict(num_layers=2, vocab_size=50_304, dtype="float32", param_dtype="float32")
    if full.family == "hybrid":
        kw["num_layers"] = full.attn_every
    if full.family == "audio":
        kw["num_layers"] = full.num_layers
    if full.name == "kimi-k2-1t-a32b":
        kw["moe"] = dataclasses.replace(full.moe, num_experts=MODEL_KIMI_EXPERTS)
    return dataclasses.replace(full, **kw)


def check_model(torch):
    """Phase 4: the model on the card (kernels) against the same model on
    the CPU (plain versions), for every arch of the registry: full width,
    ``_model_check_config``'s depth and cuts, fp32, a prefill of 37 tokens
    (whisper-tiny: over its 1,500 stub frames, drawn from a seed; qwen2-vl:
    also from stub embeds with distinct (3, B, S) M-RoPE positions) then 3
    decode steps; logits within atol 2e-3. The hybrid's decode steps on the
    card launch the ssd_step kernel once a Mamba-2 layer."""
    from repro_torch.configs import registry
    from repro_torch.models import lm

    step = kernel_table.launchers()["ssd_step"]

    for arch in registry.ARCH_NAMES:
        full = registry.get(arch)
        cfg = _model_check_config(full)
        gen = torch.Generator(device="cuda").manual_seed(7)
        p_gpu = lm.init_params(cfg, gen, "cuda")
        p_cpu = lm.params_to(p_gpu, "cpu")
        cpu_gen = torch.Generator().manual_seed(3)
        toks = torch.randint(3, cfg.vocab_size, (1, 37), generator=cpu_gen)
        inputs = {"tokens": {"tokens": toks}}
        if cfg.family == "audio":
            frames = torch.randn(1, cfg.encoder.num_frames, cfg.d_model, generator=cpu_gen)
            inputs = {"tokens": {"tokens": toks, "frames": frames}}
        if cfg.family == "vlm":
            t = torch.arange(37, dtype=torch.int32)[None]
            inputs["embeds"] = {
                "embeds": torch.randn(1, 37, cfg.d_model, generator=cpu_gen),
                "positions": torch.stack([t, t // 4, (t * 5) % 7])}
        worst = {}
        for how, inp in inputs.items():
            logits = {}
            for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
                lg, c = lm.prefill(cfg, p, cache_len=48, **{k: v.to(dev) for k, v in inp.items()})
                outs = [lg[:, -1]]
                stepped = step.launches
                for t in (5, 11, 17):
                    lg, c = lm.decode_step(cfg, p, c, torch.full((1, 1), t, device=dev))
                    outs.append(lg[:, -1])
                stepped = step.launches - stepped
                want = 3 * cfg.num_layers if dev == "cuda" and cfg.family == "hybrid" else 0
                if stepped != want:
                    raise AssertionError(f"model {arch} ({how}, {dev}): ssd_step launched "
                                         f"{stepped} times in 3 decode steps, not {want}")
                logits[dev] = torch.cat(outs).cpu()
            if not torch.isfinite(logits["cuda"]).all():
                raise AssertionError(f"model {arch} ({how}): non-finite logits on the card")
            worst[how] = (logits["cuda"] - logits["cpu"]).abs().max().item()
            if not worst[how] <= 2e-3:
                raise AssertionError(f"model {arch} ({how}): card vs CPU logits differ by "
                                     f"{worst[how]}")
        cut = (f", experts cut from {full.moe.num_experts} to {cfg.moe.num_experts} (2 layers "
               f"of all {full.moe.num_experts} are "
               f"{2 * 3 * full.moe.num_experts * full.d_model * full.moe.d_ff_expert * 4 / 1e9:.0f}"
               " GB in fp32)") if cfg.moe is not None and cfg.moe != full.moe else ""
        log(f"[model] {arch} ({cfg.num_layers} layers, fp32{cut}): card vs CPU max |dlogit| "
            + ", ".join(f"{how} {w:.3e}" for how, w in worst.items()))
        del p_gpu, p_cpu
        torch.cuda.empty_cache()


def build_engines_cut(torch, deployment):
    """One ``cut_engine`` per distinct arch of the deployment's roles; roles
    of one arch share it."""
    roles = {role: getattr(deployment, role)
             for role in ("large_planner", "small_planner", "actor", "keyword_extractor")}
    built = {arch: cut_engine(torch, arch) for arch in sorted(set(roles.values()))}
    return {role: built[arch] for role, arch in roles.items()}


def build_deployment(torch):
    """Phase 5a: the paper's deployment on the card, at full width, depth
    cut to SERVE_DEPTHS."""
    from repro_torch.configs.apc_minion import DEFAULT

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engines = build_engines_cut(torch, DEFAULT)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = {
        e.cfg.name: sum(t.numel() for t in _leaves(e.params))
        for e in {id(e): e for e in engines.values()}.values()
    }
    log(f"[serve] engines built in {init_s:.1f}s; params {n_params} (published widths, "
        f"depths { {e.cfg.name: e.cfg.num_layers for e in engines.values()} }); "
        f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return engines, init_s


def cut_engine(torch, arch, max_len=192):
    """An engine of ``arch`` at its published width (``engine_config``) and
    arch seed, depth cut to SERVE_DEPTHS[arch]."""
    from repro_torch.launch.serve import arch_seed, engine_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    cfg = dataclasses.replace(engine_config(arch, full=True), num_layers=SERVE_DEPTHS[arch])
    gen = torch.Generator(device="cuda").manual_seed(arch_seed(arch))
    return Engine(cfg, lm.init_params(cfg, gen, "cuda"), max_len=max_len, device="cuda")


def serve(torch, engines, name, env, n, make_agent, expect, path_kernels, census=None):
    """One serving run: ``n`` tasks of ``env`` (seed 0) through a fresh agent
    from ``make_agent(backend, ledger)`` on the shared engines. The kernels'
    launch counters are set to 0 just before the run and read just after;
    hits, accuracy and cost must equal the reference's (``expect``), every
    kernel of ``path_kernels`` must have been launched, and with ``census``
    the speculation outcomes (commits, patches, rollbacks) must equal it."""
    from repro_torch.configs.apc_minion import DEFAULT
    from repro_torch.core.cost_model import CostLedger
    from repro_torch.envs.workloads import get_env
    from repro_torch.serving.torch_backend import TorchBackend

    kernels = kernel_table.launchers()
    backend = TorchBackend(engines, seed=0)
    ledger = CostLedger(pricing_map=dict(DEFAULT.pricing))
    agent = make_agent(backend, ledger)
    tasks = get_env(env).generate(n, seed=0)
    uniq = {id(e): e for e in engines.values()}.values()
    before = {id(e): dataclasses.replace(e.stats) for e in uniq}

    kernel_table.reset_counts()
    t0 = time.perf_counter()
    recs = [agent.run_task(t) for t in tasks]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    launches_by_hd = {n: dict(fn.launches_by_hd) for n, fn in kernels.items()
                      if hasattr(fn, "launches_by_hd")}

    hits = sum(r.hit for r in recs)
    accuracy = sum(r.correct for r in recs) / len(recs)
    got = (hits, accuracy, round(ledger.total_cost(), 4))
    if got != tuple(expect):
        raise AssertionError(f"serve {name}: (hits, accuracy, cost) {got}, "
                             f"reference {tuple(expect)}")
    for kernel in path_kernels:
        if launches[kernel] <= 0:
            raise AssertionError(f"serve {name}: kernel {kernel} was not launched")
    outcomes = {k: sum(r.speculated and r.spec_outcome == k for r in recs)
                for k in ("commit", "patch", "rollback")}
    if census is not None and outcomes != census:
        raise AssertionError(f"serve {name}: speculation outcomes {outcomes}, reference {census}")
    store = getattr(getattr(agent, "_method", None), "store", agent.cache)
    lookups = store.stats.hits + store.stats.misses
    deltas = {}
    for role, e in engines.items():
        b = before[id(e)]
        d = {f: getattr(e.stats, f) - getattr(b, f)
             for f in ("prefill_tokens", "decode_tokens", "prefill_s", "decode_s")}
        deltas[role] = {"arch": e.cfg.name, **d,
                        "prefill_tok_s": d["prefill_tokens"] / d["prefill_s"] if d["prefill_s"] else 0.0,
                        "decode_tok_s": d["decode_tokens"] / d["decode_s"] if d["decode_s"] else 0.0}
    engine_s = sum(e.stats.prefill_s + e.stats.decode_s - before[id(e)].prefill_s
                   - before[id(e)].decode_s for e in uniq)
    out = {
        "run": name, "env": env, "agent": type(agent).__name__,
        "config": getattr(make_agent, "cfg", {}), "tasks": len(recs), "hits": hits,
        "hit_rate": hits / len(recs), "accuracy": accuracy, "cost_usd": ledger.total_cost(),
        "wall_s": wall, "wall_per_task_s": wall / len(recs), "engine_s": engine_s,
        "launches": launches, "launches_by_hd": launches_by_hd,
        "launches_per_task": {n: v / len(recs) for n, v in launches.items()},
        "spec_outcomes": outcomes,
        "lookups": lookups, "lookup_s_per_lookup": store.stats.lookup_time_s / max(1, lookups),
        "calls": {role: u.calls for role, u in sorted(ledger.usage.items())},
        "engines": deltas,
    }
    log(f"[serve] {name} ({env}): {len(recs)} tasks, accuracy {accuracy:.4f}, hits {hits}, cost "
        f"${ledger.total_cost():.4f}, wall {wall:.1f}s ({wall / len(recs):.2f}s a task), "
        f"launches {launches}, lookup {out['lookup_s_per_lookup'] * 1e3:.3f} ms each "
        f"over {lookups} lookups")
    return out


def compare_baselines(runs):
    """The paper's headline comparison on one set of tasks: APC (the
    ``exact`` run) against the ``accuracy_optimal`` baseline served directly
    after it. Cost, wall time and engine seconds of each, and APC's over the
    baseline's. Each wall is one run, so the ratio holds host drift between
    two neighbouring runs (about a minute each)."""
    order = list(runs)
    if order.index("accuracy_optimal") != order.index("exact") + 1:
        raise AssertionError(f"baselines: accuracy_optimal must run directly after exact: {order}")
    apc, base = runs["exact"], runs["accuracy_optimal"]
    if (apc["env"], apc["tasks"]) != (base["env"], base["tasks"]):
        raise AssertionError(f"baselines: runs on different tasks: {apc['env']}/"
                             f"{apc['tasks']} against {base['env']}/{base['tasks']}")
    keys = ("hits", "accuracy", "cost_usd", "wall_s", "engine_s")
    out = {"env": apc["env"], "tasks": apc["tasks"], "order": ["exact", "accuracy_optimal"],
           "apc": {k: apc[k] for k in keys},
           "accuracy_optimal": {k: base[k] for k in keys},
           "apc_over_accuracy_optimal": {k: apc[k] / base[k]
                                         for k in ("cost_usd", "wall_s", "engine_s")}}
    log(f"[baselines] apc / accuracy_optimal on {out['tasks']} {out['env']} tasks: "
        f"{out['apc_over_accuracy_optimal']}")
    return out


def template_ids(tok, task):
    """The token ids of a task's plan template, as the router's cache
    generation distills it: the canonical plan of the task's intent (its
    retrieval rounds and final computation), rendered and tokenized."""
    it = task.intent
    rounds = " ; ".join(f"round {n + 1}: retrieve " + ", ".join(r)
                        for n, r in enumerate(it.rounds))
    text = f"plan template for {it.keyword}: {rounds} ; then compute {it.expr}"
    return tok.encode(text)


def _prefix_parity(torch, eng, cfg_name, B, Sp, Ss, max_new, seed):
    """One miss (full prefill + registration) and one hit (suffix-only
    prefill) of ``generate(cache_point=)`` on a prefix engine, plus the
    prefill logits and cache of the prefix path against a full prefill of
    the same prompt. Returns the numbers; raises if a counter is off."""
    import numpy as np

    from repro_torch.serving.kv_cache import plan_cache_point

    rs = np.random.RandomState(seed)
    vocab = eng.cfg.vocab_size
    tpl = rs.randint(16, vocab, (Sp,)).astype(np.int32)
    suffix = rs.randint(16, vocab, (B, Ss)).astype(np.int32)
    toks = np.concatenate([np.broadcast_to(tpl, (B, Sp)), suffix], axis=1)
    tid = f"parity-{cfg_name}"
    cp = plan_cache_point(tid, tpl, toks)
    plain = eng.generate(toks, max_new=max_new)
    s0 = dataclasses.replace(eng.stats)
    t0 = time.perf_counter()
    miss = eng.generate(toks, max_new=max_new, cache_point=cp)
    s1 = dataclasses.replace(eng.stats)
    hit = eng.generate(toks, max_new=max_new, cache_point=cp)
    s2 = dataclasses.replace(eng.stats)
    torch.cuda.synchronize()
    if eng.kv_prefix.length_of(tid) != Sp:
        raise AssertionError(f"prefix {cfg_name}: the miss did not register {Sp} tokens")
    got = (s1.prefix_tokens_reused - s0.prefix_tokens_reused,
           s1.prefill_tokens - s0.prefill_tokens,
           s2.prefix_tokens_reused - s1.prefix_tokens_reused,
           s2.prefill_tokens - s1.prefill_tokens)
    if got != (0, B * (Sp + Ss), B * Sp, B * Ss):
        raise AssertionError(f"prefix {cfg_name}: (reused, prefilled) miss/hit {got}, want "
                             f"{(0, B * (Sp + Ss), B * Sp, B * Ss)}")
    # warm: both paths have run once above
    lf, cf = eng.prefill(toks)
    s3 = dataclasses.replace(eng.stats)
    lp, cpx = eng.prefill_with_prefix(tid, suffix, expected_len=Sp)
    s4 = dataclasses.replace(eng.stats)
    torch.cuda.synchronize()
    n = Sp + Ss
    k_full, k_pfx = cf["kv_k"][:, :, :n].float(), cpx["kv_k"][:, :, :n].float()
    return {
        "B": B, "Sp": Sp, "Ss": Ss,
        "miss_prefill_s": s1.prefill_s - s0.prefill_s,
        "hit_prefill_s": s2.prefill_s - s1.prefill_s,
        "full_prefill_s_warm": s3.prefill_s - s2.prefill_s,
        "suffix_prefill_s_warm": s4.prefill_s - s3.prefill_s,
        "prefill_tokens_miss": got[1], "prefill_tokens_hit": got[3],
        "prefix_tokens_reused_hit": got[2],
        "generate_s": time.perf_counter() - t0,
        "tokens_equal_plain_miss_hit": [bool((plain == miss).all()), bool((plain == hit).all())],
        "logits_max_abs": float(lf.float().abs().max()),
        "logits_max_abs_diff": float((lf.float() - lp.float()).abs().max()),
        "argmax_equal": bool((lf.argmax(-1) == lp.argmax(-1)).all()),
        "prefix_kv_bitwise": bool(torch.equal(cf["kv_k"][:, :, :Sp], cpx["kv_k"][:, :, :Sp])
                                  and torch.equal(cf["kv_v"][:, :, :Sp], cpx["kv_v"][:, :, :Sp])),
        "kv_max_abs": float(k_full.abs().max()),
        "kv_max_abs_diff": float(max((k_full - k_pfx).abs().max(),
                                     (cf["kv_v"][:, :, :n].float()
                                      - cpx["kv_v"][:, :, :n].float()).abs().max())),
    }


def paged_over_pool(torch, kv, cfg, template_ids, seed):
    """The paged decode kernel over a live pool, t8-style: for each template,
    4 leases, a page table, and every layer's slabs, bitwise against the
    dense decode kernel on the pages gathered in table order. Returns the
    number of layer checks."""
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 0
    for tid in template_ids:
        leases = [kv.acquire(tid) for _ in range(4)]
        table, lengths = kv.page_table(leases)
        q = torch.randn(4, 1, cfg.num_heads, cfg.head_dim, generator=g,
                        device="cuda").to(kv.pool.kernel_view(0)[0].dtype)
        for layer in range(cfg.num_layers):
            kp, vp = kv.pool.kernel_view(layer)
            o = ops.paged_decode_attention_op(q, kp, vp, table, lengths)
            od = ops.decode_attention_op(q, _gather_pages(torch, kp, table),
                                         _gather_pages(torch, vp, table), lengths)
            if not torch.equal(o, od):
                raise AssertionError(f"{cfg.name} paged decode {tid!r} layer {layer}: not "
                                     "bitwise equal to decode_attention on the gathered cache")
            n += 1
        for lease in leases:
            kv.release_lease(lease)
    torch.cuda.synchronize()
    return n


KV_COUNTERS = ("pages_built", "pages_hit", "prefix_evictions", "tokens_prefetched")
KV_LABELS = {"engine": "small_planner"}


def kv_counters(kv):
    """The prefix cache's four counters, read from its attributes and from
    its registry's ``snapshot()`` (the ``kv.*`` series under KV_LABELS),
    which must agree."""
    snap = kv.obs.snapshot()
    key = ",".join(f"{k}={v}" for k, v in sorted(KV_LABELS.items()))
    reg = {n: snap.get(f"kv.{n}", {}).get(key) for n in KV_COUNTERS}
    attrs = {n: getattr(kv, n) for n in KV_COUNTERS}
    if reg != attrs:
        raise AssertionError(f"prefix: the prefix cache's counters {attrs}, its registry's "
                             f"{reg}")
    return attrs


def serve_prefix(torch, engines):
    """Phase 5c, the paged KV prefix path: (1) prefix parity of a second
    olmo-1b engine (the small planner, on the same parameter tensors) with a
    64-page pool of 32-token pages, at full width in bf16, and greedy token
    identity on a 2-layer full-width fp32 olmo-1b; (2) the port's
    TwoTierRouter over a 4-entry plan cache, wired to that pool, routing
    the 16 tasks in waves (``router_waves``): misses run nemotron, hits run
    the prefix engine with the template's cache point, and after every wave
    the pool holds only plan-cache keys and no page is lost, and the prefix
    cache's counters read alike from its registry and its attributes
    (``kv_counters``); (3) the paged
    decode kernel over the live pool, t8-style: for each template left, 4
    leases, a page table, and every layer's slabs, bitwise against the
    dense decode kernel on the pages gathered in table order. The kernels'
    counters are set to 0 before and read after."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.cache import PlanCache
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.envs.workloads import get_env
    from repro_torch.models import lm
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_cache import KVPrefixCache, plan_cache_point, pool_for_config
    from repro_torch.serving.router import TwoTierRouter

    kernels = kernel_table.reset_counts()
    t_phase = time.perf_counter()
    olmo, nemo = engines["small_planner"], engines["large_planner"]
    kv = KVPrefixCache(pool_for_config(olmo.cfg, num_pages=64, page_size=32, device="cuda"),
                       obs=MetricsRegistry(), obs_labels=KV_LABELS)
    peng = Engine(olmo.cfg, olmo.params, max_len=olmo.max_len, device="cuda", kv_prefix=kv)
    if any(a is not b for a, b in zip(_leaves(peng.params), _leaves(olmo.params))):
        raise AssertionError("prefix: the prefix engine must share olmo's parameter tensors")

    # (1) parity at full width, bf16: logits within 2^-5 of the largest
    # logit (8 bf16 ulps there; the two prefills round the bf16 residual
    # stream differently in every layer), the cached prefix K/V bitwise
    # (it is copied, not recomputed), the suffix K/V within 2^-5 of the
    # largest |K/V|
    par = _prefix_parity(torch, peng, "olmo-1b", B=4, Sp=96, Ss=32, max_new=16, seed=11)
    for what in ("logits", "kv"):
        lim = 2 ** -5 * par[f"{what}_max_abs"]
        if not par[f"{what}_max_abs_diff"] <= lim:
            raise AssertionError(f"prefix olmo-1b bf16: {what} max abs diff "
                                 f"{par[what + '_max_abs_diff']} > {lim}")
    if not par["prefix_kv_bitwise"]:
        raise AssertionError("prefix olmo-1b bf16: the cached prefix K/V is not the full "
                             "prefill's")
    # greedy identity in fp32 at full width, depth 2: logits within 2e-3
    # (the bound of the model check, card against CPU)
    cfg32 = dataclasses.replace(registry.get("olmo-1b"), num_layers=2, vocab_size=50_304,
                                dtype="float32", param_dtype="float32")
    p32 = lm.init_params(cfg32, torch.Generator(device="cuda").manual_seed(7), "cuda")
    kv32 = KVPrefixCache(pool_for_config(cfg32, num_pages=16, page_size=32, device="cuda"))
    e32 = Engine(cfg32, p32, max_len=olmo.max_len, device="cuda", kv_prefix=kv32)
    par32 = _prefix_parity(torch, e32, "olmo-1b-2l-fp32", B=4, Sp=96, Ss=32, max_new=16,
                           seed=12)
    if not all(par32["tokens_equal_plain_miss_hit"]):
        raise AssertionError("prefix olmo-1b fp32: greedy tokens with the cache point differ "
                             "from those without it")
    if not (par32["logits_max_abs_diff"] <= 2e-3 and par32["prefix_kv_bitwise"]):
        raise AssertionError(f"prefix olmo-1b fp32: logits differ by "
                             f"{par32['logits_max_abs_diff']}, or the prefix K/V is not "
                             "the full prefill's")
    del e32, p32, kv32
    log(f"[prefix] parity: bf16 {par}; fp32 2 layers {par32}")
    kv.clear()  # the parity template is no plan-cache key

    # (2) the router waves
    tok = HashTokenizer()
    tasks = get_env("financebench").generate(N_TASKS, seed=0)
    cache = PlanCache(capacity=ROUTER_CAPACITY)

    def plan_large(task):
        nemo.generate(np.asarray([tok.encode(task.query)], np.int32), max_new=ROUTER_NEW)
        return {"plan": "fresh"}

    def make_template(task, result):
        return {"id": task.intent.keyword,
                "tokens": np.asarray(template_ids(tok, task), np.int32)}

    def plan_small(task, tpl):
        prompt = np.concatenate([tpl["tokens"], tok.encode(task.query, add_bos=False)])[None]
        point = plan_cache_point(tpl["id"], tpl["tokens"], prompt)
        if point is None:
            raise AssertionError(f"prefix: no cache point for {tpl['id']!r}")
        peng.generate(prompt.astype(np.int32), max_new=ROUTER_NEW, cache_point=point)
        return {"plan": "adapted"}

    router = TwoTierRouter(cache, extract_keyword=lambda t: t.intent.keyword,
                           plan_large=plan_large, plan_small_with_template=plan_small,
                           make_template=make_template, async_cachegen=False, kv_prefix=kv)
    s0 = dataclasses.replace(peng.stats)
    c0 = kv_counters(kv)
    ps, N = kv.pool.page_size, kv.pool.num_pages
    t0 = time.perf_counter()
    for w, wave in enumerate(router_waves(tasks)):
        router.route_batch(wave)
        stale = set(kv.keys()) - set(cache.keys())
        if stale:
            raise AssertionError(f"prefix wave {w}: the pool holds {sorted(stale)}, which "
                                 "the plan cache evicted")
        held = kv.keys()
        in_use = int((kv.pool.refcount > 0).sum())
        pages = sum(-(-kv.length_of(t) // ps) for t in held)
        if not (in_use == pages and in_use + kv.pool.free_pages == N):
            raise AssertionError(f"prefix wave {w}: {in_use} pages in use, {pages} held by "
                                 f"{len(held)} prefixes, {kv.pool.free_pages} free of {N}")
    router.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = router.metrics
    if (m.hits, m.misses) != ROUTER_EXPECT:
        raise AssertionError(f"prefix router: (hits, misses) {(m.hits, m.misses)}, "
                             f"reference {ROUTER_EXPECT}")
    reused = peng.stats.prefix_tokens_reused - s0.prefix_tokens_reused
    if not reused > 0:
        raise AssertionError("prefix router: no prefix token was reused")
    held = kv.keys()
    c1 = kv_counters(kv)
    router_out = {
        "waves": len(router_waves(tasks)), "requests": m.requests, "hits": m.hits,
        "misses": m.misses, "prefix_tokens_reused": reused,
        "prefill_tokens": peng.stats.prefill_tokens - s0.prefill_tokens,
        **{n: c1[n] - c0[n] for n in KV_COUNTERS}, "counters_from_registry": True,
        "templates_left": len(held), "wall_s": wall,
        "lookup_s": m.lookup_s, "lookup_s_per_wave": m.lookup_s / len(router_waves(tasks)),
        "small_prefill_s": peng.stats.prefill_s - s0.prefill_s,
        "small_decode_s": peng.stats.decode_s - s0.decode_s,
    }
    log(f"[prefix] router: {router_out}")

    # (3) the paged decode kernel over the live pool, t8-style
    n_paged = paged_over_pool(torch, kv, olmo.cfg, held, seed=13)
    launches = {n: fn.launches for n, fn in kernels.items()}
    for n in ("flash_attention", "decode_attention", "paged_decode_attention"):
        if launches[n] <= 0:
            raise AssertionError(f"prefix: kernel {n} was not launched")
    if kv.pool.free_pages + sum(-(-kv.length_of(t) // ps) for t in held) != N:
        raise AssertionError("prefix: the leases leaked pages")
    out = {"run": "prefix", "parity_bf16": par, "parity_fp32_2_layers": par32,
           "router": router_out, "paged_checks": n_paged, "launches": launches,
           "wall_s": time.perf_counter() - t_phase}
    log(f"[prefix] paged decode over the live pool: {n_paged} layer checks bitwise equal; "
        f"launches {launches}; phase {out['wall_s']:.1f}s")
    return out


def serve_dcache(torch, engines):
    """Phase 7(b): the port's TwoTierRouter over a DistributedPlanCache on the
    card (DCACHE_NODES nodes, replication 2, fuzzy at 0.6 on the `device`
    index: a bank on the card per shard, one top-k launch per probed shard),
    routing the 16 FinanceBench tasks in ``dcache_waves`` under a Tracer with
    an in-memory and a JSONL exporter. Misses run nemotron-4-15b, hits
    olmo-1b, and each near hit's verification runs nemotron and then
    ``dcache_verdict``; cache generation is synchronous (the engines are not
    thread-safe). cache-1 is marked down after the sixth wave and restarted
    with read-repair after the eighth: the restart must not grow the memory
    allocated on the card. The counters must equal the reference router's
    (DCACHE_EXPECT), the top-k launches the index calls of the CPU run
    (DCACHE_TOPK_CALLS) and this run's ``index.topk`` spans, and the span
    forest must pass ``check_span_forest``."""
    import numpy as np

    from repro_torch.core.distributed_cache import DistributedPlanCache
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.envs.workloads import get_env
    from repro_torch.obs import (InMemoryExporter, JsonlExporter, Tracer, port_names,
                                 use_tracer, write_chrome_trace)
    from repro_torch.obs.names import EVENT_NAMES, SPAN_NAMES
    from repro_torch.serving.router import TwoTierRouter

    kernels = kernel_table.launchers()
    tok = HashTokenizer()
    nemo, olmo = engines["large_planner"], engines["small_planner"]
    tasks = get_env("financebench").generate(N_TASKS, seed=0)
    verdict = dcache_verdict(tasks)

    def run(eng, request):
        eng.generate(np.asarray([tok.encode(request[0].query)], np.int32), max_new=ROUTER_NEW)

    def plan_large(request):
        run(nemo, request)
        return {"plan": "fresh"}

    def plan_small(request, tpl):
        run(olmo, request)
        return {"plan": "adapted", "from": tpl["id"]}

    def spec_verify(request, matched_key):
        run(nemo, request)
        return verdict(dcache_keyword(request), matched_key)

    def allocated():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    cache = DistributedPlanCache(n_nodes=DCACHE_NODES, replication=2, fuzzy=True,
                                 fuzzy_threshold=0.6, index_backend="device", device="cuda",
                                 capacity_per_node=ROUTER_CAPACITY)
    router = TwoTierRouter(cache, extract_keyword=dcache_keyword, plan_large=plan_large,
                           plan_small_with_template=plan_small,
                           make_template=lambda req, res: {"id": req[0].intent.keyword,
                                                           "plan": "fresh"},
                           async_cachegen=False, spec_verify=spec_verify)
    out_dir = os.path.join(ROOT, "trace-out", "dcache")
    os.makedirs(out_dir, exist_ok=True)
    mem = InMemoryExporter()
    tracer = Tracer(exporters=[mem, JsonlExporter(os.path.join(out_dir, "trace.jsonl"))])
    waves = dcache_waves(tasks)
    kernel_table.reset_counts()
    t0 = time.perf_counter()
    with use_tracer(tracer):
        repaired, mem_before, mem_after = drive_dcache(router, cache, waves, probe=allocated)
    router.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in kernels.items()}
    tracer.close()
    write_chrome_trace(os.path.join(out_dir, "trace_chrome.json"), mem.spans)

    m = router.metrics
    got = {k: getattr(m, k) for k in DCACHE_EXPECT}
    if got != DCACHE_EXPECT:
        raise AssertionError(f"dcache router: counters {got}, reference {DCACHE_EXPECT}")
    for n in ATTN_TOPK:
        if launches[n] <= 0:
            raise AssertionError(f"dcache: kernel {n} was not launched")
    topk_spans = sum(s["name"] == "index.topk" for s in mem.spans)
    if not launches["topk_cosine"] == topk_spans == DCACHE_TOPK_CALLS:
        raise AssertionError(f"dcache: {launches['topk_cosine']} top-k launches, {topk_spans} "
                             f"index.topk spans, {DCACHE_TOPK_CALLS} index calls on the CPU")
    if not repaired > 0:
        raise AssertionError("dcache: the restart repaired no entry")
    if mem_after > mem_before:
        raise AssertionError(f"dcache: memory allocated on the card grew across the restart "
                             f"({mem_before} -> {mem_after} bytes): the old bank was not freed")
    # the engines' phases (engine.prefill, engine.decode_step) are the port's own spans
    counts, chains, routed = check_span_forest(mem.spans, SPAN_NAMES + port_names.SPAN_NAMES,
                                               EVENT_NAMES)
    by_arch = {}
    for s in mem.spans:
        if s["name"] == "engine.generate":
            by_arch.setdefault(s["attrs"]["arch"], []).append(s["end"] - s["start"])
    generate_s = {a: {"n": len(d), "p50": float(np.percentile(d, 50)),
                      "p99": float(np.percentile(d, 99))} for a, d in sorted(by_arch.items())}
    snap = cache.obs.snapshot()
    out = {
        "run": "dcache", "waves": len(waves), "wall_s": wall, "repaired": repaired,
        "memory_allocated_around_restart": [mem_before, mem_after],
        "counters": {k: v for k, v in m.snapshot().items() if k != "lookup_latency"},
        "lookup_latency_s": m.lookup_latency.snapshot(), "launches": launches,
        "launches_per_request": {n: v / m.requests for n, v in launches.items()},
        "span_counts": counts, "serving_chains": chains, "routed_generates": routed,
        "engine_generate_s": generate_s,
        "cache_series": {k: v for k, v in snap.items() if k.startswith("cache.")},
        "load_by_node": cache.load_by_node(),
    }
    log(f"[dcache] {m.requests} requests in {len(waves)} waves, wall {wall:.1f}s: counters "
        f"{got}; launches {launches}; repaired {repaired}; allocated around the restart "
        f"{mem_before} -> {mem_after} bytes; generate {generate_s}")
    return out


def build_recurrent(torch, engines):
    """Phase 5d: the recurrent run's engines: rwkv6-3b and zamba2-2.7b at
    full width, depth cut to SERVE_DEPTHS (``cut_engine``; roles of one arch
    share it), the large planner the deployment phase's nemotron-4-15b
    engine (no second copy of its weights)."""
    from repro_torch.configs import registry

    t0 = time.perf_counter()
    built = {arch: cut_engine(torch, arch) for arch in sorted(set(RECURRENT_ROLES.values()))}
    own = {role: built[arch] for role, arch in RECURRENT_ROLES.items()}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rec = {**own, "large_planner": engines["large_planner"]}
    n_params = {arch: sum(t.numel() for t in _leaves(e.params)) for arch, e in built.items()}
    widened = {arch: e.cfg.vocab_size for arch, e in built.items()
               if e.cfg.vocab_size != registry.get(arch).vocab_size}
    log(f"[recurrent] engines built in {init_s:.1f}s; params {n_params} (published "
        f"widths, depths {({a: SERVE_DEPTHS[a] for a in built})}; vocabularies widened to "
        f"the tokenizer's: {widened}); allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return rec, init_s, n_params


def check_shared_block(cfg, launches_by_hd):
    """The recurrent run went through the attention kernels at the hybrid
    actor's head dim (80, a case that only its shared block launches): each
    of its prefills launches flash attention and each of its decode steps
    launches decode attention once per application of the shared block
    (``num_layers // attn_every``), so both counts are positive multiples
    of that."""
    apps = cfg.num_layers // cfg.attn_every
    for n in ("flash_attention", "decode_attention"):
        got = launches_by_hd[n].get(cfg.head_dim, 0)
        if got <= 0 or got % apps:
            raise AssertionError(f"recurrent: {n} launched {got} times at hd "
                                 f"{cfg.head_dim}; need a positive multiple of {apps}")
    log(f"[recurrent] shared block at hd {cfg.head_dim}: flash "
        f"{launches_by_hd['flash_attention'][cfg.head_dim]}, decode "
        f"{launches_by_hd['decode_attention'][cfg.head_dim]} launches "
        f"({apps} applications a call)")


def check_step_launches(cfg, launches):
    """Each decode step of the recurrent run's hybrid actor stepped every one
    of its Mamba-2 layers (``num_layers``) through the ssd_step kernel: a
    positive multiple of that."""
    got = launches["ssd_step"]
    if got <= 0 or got % cfg.num_layers:
        raise AssertionError(f"recurrent: ssd_step launched {got} times; need a positive "
                             f"multiple of {cfg.num_layers}")
    log(f"[recurrent] ssd_step: {got} launches ({cfg.num_layers} Mamba-2 layers a step)")


class ChunkDecayProbe:
    """While active, records the largest |la| of the recurrent run: a
    chunk's cumulative log decay as the chunked plain versions form it at
    the model's chunk (wkv6: cumsum of w_log; ssd: of -dt exp(A_log)),
    over every wkv6/ssd call. Past ~88, exp(-la) (``rwkv.py:113``) or
    exp(la_i - la_j) (``mamba.py:104-106``) overflows in fp32. It wraps
    ``ops.wkv6_op``/``ops.ssd_op`` (the kernels' launch counts are
    untouched) and keeps the maximum on the device, with no sync."""

    def __init__(self, torch):
        self.torch = torch
        self.max = {"wkv6": None, "ssd": None}

    def _record(self, name, logdecay, chunk):
        torch = self.torch
        B, S = logdecay.shape[:2]
        pad = (-S) % chunk
        ld = torch.cat([logdecay, logdecay.new_zeros((B, pad) + tuple(logdecay.shape[2:]))], 1)
        la = ld.reshape(B, -1, chunk, *ld.shape[2:]).cumsum(2).abs().max()
        self.max[name] = la if self.max[name] is None else torch.maximum(self.max[name], la)

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.orig = ops, (ops.wkv6_op, ops.ssd_op)
        wkv6_op, ssd_op = self.orig

        def wkv6_probe(r, k, v, w_log, u, *, chunk=64):
            self._record("wkv6", w_log, chunk)
            return wkv6_op(r, k, v, w_log, u, chunk=chunk)

        def ssd_probe(x, dt, A_log, B_, C_, D, *, chunk=128):
            self._record("ssd", dt.float() * -self.torch.exp(A_log.float()), chunk)
            return ssd_op(x, dt, A_log, B_, C_, D, chunk=chunk)

        ops.wkv6_op, ops.ssd_op = wkv6_probe, ssd_probe
        return self

    def __exit__(self, *exc):
        self.ops.wkv6_op, self.ops.ssd_op = self.orig

    def result(self):
        return {n: (None if m is None else m.item()) for n, m in self.max.items()}


def build_families(torch, engines):
    """Phase 8a: the families run's engines: granite-moe-1b-a400m, qwen3-4b
    and qwen2-vl-7b at full published width in bf16, depth cut to
    SERVE_DEPTHS (``cut_engine``; granite's 49,155-entry vocabulary widened
    to the tokenizer's 50,304, as ``engine_config`` does), the large planner
    the deployment phase's nemotron-4-15b engine."""
    from repro_torch.configs.apc_minion import APCDeployment

    t0 = time.perf_counter()
    own = build_engines_cut(torch, APCDeployment(
        large_planner=FAMILIES_ROLES["small_planner"], **FAMILIES_ROLES))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fam = {**own, "large_planner": engines["large_planner"]}
    n_params = {e.cfg.name: sum(t.numel() for t in _leaves(e.params))
                for e in {id(e): e for e in own.values()}.values()}
    log(f"[families] engines built in {init_s:.1f}s; params {n_params}; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return fam, init_s, n_params


def check_served(name, run, roles):
    """Each role of ``roles`` decoded tokens in the run ``run``."""
    idle = [r for r in roles if run["engines"][r]["decode_tokens"] <= 0]
    if idle:
        raise AssertionError(f"serve {name}: the engines of {idle} decoded no token")


def _prefix_fp32(torch, arch, seed):
    """The prefix path of ``arch`` at full width, 2 layers, vocabulary
    50,304 (as phase 4), fp32, B = 4, a 96-token prefix and a 32-token
    suffix: ``prefill_extend`` over a full
    prefill's prefix K/V, then 3 decode steps, on the card and on the CPU.
    Returns (max |dlogit| card vs CPU, max |dlogit| on the card of the
    prefix path's last suffix position against a full prefill of the whole
    prompt)."""
    from repro_torch.launch.serve import engine_config
    from repro_torch.models import lm

    cfg = dataclasses.replace(engine_config(arch, full=True), num_layers=2, vocab_size=50_304,
                              dtype="float32", param_dtype="float32")
    p_gpu = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    p_cpu = lm.params_to(p_gpu, "cpu")
    toks = torch.randint(16, cfg.vocab_size, (4, 129), generator=torch.Generator().manual_seed(seed))
    logits = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        t = toks.to(dev)
        _, c = lm.prefill(cfg, p, t[:, :96], cache_len=96)
        lg, c = lm.prefill_extend(cfg, p, t[:, 96:128], c["kv_k"], c["kv_v"], 96, cache_len=160)
        outs = [lg[:, -1]]
        for i in range(3):
            lg, c = lm.decode_step(cfg, p, c, (t[:, 128:129] + i) % cfg.vocab_size)
            outs.append(lg[:, -1])
        logits[dev] = torch.cat(outs).cpu()
    full, _ = lm.prefill(cfg, p_gpu, toks[:, :128].cuda())
    vs_full = (full[:, -1].cpu() - logits["cuda"][:4]).abs().max().item()
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return (logits["cuda"] - logits["cpu"]).abs().max().item(), vs_full


def serve_prefix_families(torch, fam):
    """Phase 8b, the paged KV prefix path on the prefix families' engines
    (granite-moe-1b-a400m, hd 64; qwen2-vl-7b, G = 7), each with its own
    64-page pool of 32-token pages on the served parameter tensors:
    ``_prefix_parity`` at t8's shape (B = 4, 96 + 32 tokens, bf16, the
    served depth), the cached prefix K/V bitwise equal to the full prefill's, and
    the paged kernel over the pool (``paged_over_pool``), whose launches are
    counted by head dim. Logits are held in fp32 at 2 layers
    (``_prefix_fp32``): the prefix path on the card within 2e-3 of the same
    path on the CPU, and for qwen2-vl within 2e-3 of a full prefill.
    granite's GShard dispatch gives each call its own capacity (the full
    prefill's group is the 128-token row, the suffix prefill's the 32-token
    suffix), so its two paths drop different (token, expert) pairs, in the
    reference as here. The bf16 logits differences are reported, not
    bounded: over qwen2-vl's 28 layers the two paths' bf16 roundings part
    by more than the olmo run's 2^-5 of the largest logit."""
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_cache import KVPrefixCache, pool_for_config

    kernels = kernel_table.reset_counts()
    t0 = time.perf_counter()
    out = {}
    for i, role in enumerate(("small_planner", "actor")):  # granite, qwen2-vl
        eng = fam[role]
        cfg = eng.cfg
        kv = KVPrefixCache(pool_for_config(cfg, num_pages=64, page_size=32, device="cuda"))
        peng = Engine(cfg, eng.params, max_len=eng.max_len, device="cuda", kv_prefix=kv)
        par = _prefix_parity(torch, peng, cfg.name, B=4, Sp=96, Ss=32, max_new=16,
                             seed=21 + i)
        if not par["prefix_kv_bitwise"]:
            raise AssertionError(f"prefix {cfg.name}: the cached prefix K/V is not the full "
                                 "prefill's")
        par["logits_rel_diff"] = par["logits_max_abs_diff"] / par["logits_max_abs"]
        par["paged_checks"] = paged_over_pool(torch, kv, cfg, kv.keys(), seed=31 + i)
        vs_cpu, vs_full = _prefix_fp32(torch, FAMILIES_ROLES[role], seed=41 + i)
        par["fp32_2_layers"] = {"card_vs_cpu": vs_cpu, "prefix_vs_full_prefill": vs_full}
        if not vs_cpu <= 2e-3:
            raise AssertionError(f"prefix {cfg.name} fp32: card vs CPU logits differ by "
                                 f"{vs_cpu}")
        if cfg.moe is None and not vs_full <= 2e-3:
            raise AssertionError(f"prefix {cfg.name} fp32: the prefix path's logits differ "
                                 f"from a full prefill's by {vs_full}")
        out[cfg.name] = par
        kv.clear()
        del peng, kv
    torch.cuda.synchronize()
    by_hd = dict(kernels["paged_decode_attention"].launches_by_hd)
    for hd in {fam[role].cfg.head_dim for role in ("small_planner", "actor")}:  # 64, 128
        if by_hd.get(hd, 0) <= 0:
            raise AssertionError(f"prefix families: paged decode not launched at hd {hd}: "
                                 f"{by_hd}")
    launches = {n: fn.launches for n, fn in kernels.items()}
    res = {"run": "prefix_families", "parity": out, "launches": launches,
           "paged_launches_by_hd": by_hd, "wall_s": time.perf_counter() - t0}
    log(f"[families] prefix path: {res}")
    return res


def build_flagship(torch, engines):
    """Phase 8c: the FLAGSHIP deployment's engines: kimi-k2-1t-a32b at its
    published width with depth cut to FLAGSHIP_DEPTH (61 layers are ~2 TB in
    bf16; one card holds 80 GB), its other roles the DEFAULT engines of the
    same archs (olmo-1b and qwen2.5-3b, cut to SERVE_DEPTHS)."""
    from repro_torch.configs.apc_minion import DEFAULT, FLAGSHIP
    from repro_torch.launch.serve import arch_seed, engine_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    arch = FLAGSHIP.large_planner
    t0 = time.perf_counter()
    cfg = dataclasses.replace(engine_config(arch, full=True), num_layers=FLAGSHIP_DEPTH)
    gen = torch.Generator(device="cuda").manual_seed(arch_seed(arch))
    kimi = Engine(cfg, lm.init_params(cfg, gen, "cuda"), max_len=192, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    flag = {"large_planner": kimi}
    for role in ("small_planner", "actor", "keyword_extractor"):
        if getattr(FLAGSHIP, role) != getattr(DEFAULT, role):
            raise AssertionError(f"flagship: its {role} is not the DEFAULT engine's arch")
        flag[role] = engines[role]
    n_params = sum(t.numel() for t in _leaves(kimi.params))
    log(f"[flagship] {arch} built in {init_s:.1f}s at published width, depth cut from "
        f"{engine_config(arch, full=True).num_layers} to {FLAGSHIP_DEPTH} (61 layers are "
        f"~2 TB in bf16; one card holds 80 GB): {n_params} params; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return flag, init_s, n_params


def check_whisper(torch):
    """Phase 8d: whisper-tiny at published width and depth: 1,500 stub
    frames drawn from a seed, a 32-token prompt, then 16 greedy decode
    steps, in fp32 and bf16 on the card. fp32: every step's logits against
    the CPU's (teacher-forced with the card's tokens) within 2e-3; bf16:
    finite. Each prefill launches flash bidirectional once per encoder
    layer and causal once per decoder layer, each step decode once per
    decoder layer."""
    from repro_torch.configs import registry
    from repro_torch.models import lm

    kernels = kernel_table.launchers()
    flash, decode = kernels["flash_attention"], kernels["decode_attention"]
    full = registry.get("whisper-tiny")
    cpu_gen = torch.Generator().manual_seed(51)
    frames = torch.randn(1, full.encoder.num_frames, full.d_model, generator=cpu_gen)
    prompt = torch.randint(3, full.vocab_size, (1, 32), generator=cpu_gen)
    steps = 16
    out = {}
    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(full, dtype=dname, param_dtype=dname)
        p_gpu = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(52), "cuda")
        kernel_table.reset_counts()
        t0 = time.perf_counter()
        lg, c = lm.prefill(cfg, p_gpu, prompt.cuda(), cache_len=64, frames=frames.cuda())
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        got = {"noncausal": flash.launches_by_causal[False],
               "causal": flash.launches_by_causal[True]}
        want = {"noncausal": cfg.encoder.num_layers, "causal": cfg.num_layers}
        if got != want:
            raise AssertionError(f"whisper {dname}: flash launches {got}, want {want}")
        logits, toks = [lg[:, -1]], []
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = logits[-1].argmax(-1, keepdim=True)
            toks.append(tok)
            lg, c = lm.decode_step(cfg, p_gpu, c, tok)
            logits.append(lg[:, -1])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        if decode.launches != steps * cfg.num_layers:
            raise AssertionError(f"whisper {dname}: decode launched {decode.launches} times, "
                                 f"want {steps * cfg.num_layers}")
        card = torch.cat(logits).float().cpu()
        if not torch.isfinite(card).all():
            raise AssertionError(f"whisper {dname}: non-finite logits on the card")
        res = {"prefill_s": prefill_s, "decode_s": decode_s,
               "decode_tok_s": steps / decode_s, "flash_launches": got,
               "decode_launches": decode.launches}
        if dname == "float32":
            p_cpu = lm.params_to(p_gpu, "cpu")
            lc, cc = lm.prefill(cfg, p_cpu, prompt, cache_len=64, frames=frames)
            cpu = [lc[:, -1]]
            for tok in toks:
                lc, cc = lm.decode_step(cfg, p_cpu, cc, tok.cpu())
                cpu.append(lc[:, -1])
            res["card_vs_cpu_max_abs"] = (card - torch.cat(cpu)).abs().max().item()
            if not res["card_vs_cpu_max_abs"] <= 2e-3:
                raise AssertionError(f"whisper fp32: card vs CPU logits differ by "
                                     f"{res['card_vs_cpu_max_abs']}")
            del p_cpu
        out[dname] = res
        del p_gpu
        torch.cuda.empty_cache()
    log(f"[whisper] {full.name} ({full.encoder.num_layers} + {full.num_layers} layers, "
        f"{full.encoder.num_frames} frames, {steps} greedy steps): {out}")
    return out


def _bitwise_equal(torch, a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def train_full(torch, ckpt_dir):
    """Phase 9(a): olmo-1b at published width, TRAIN_LAYERS layers, trained TRAIN_STEPS steps
    through the port's FaultTolerantRunner (checks in the constants'
    comment). Returns (its config, the final parameters, the phase's
    record)."""
    import math

    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.configs import registry
    from repro_torch.distributed.fault import FaultEvent, FaultPolicy, FaultTolerantRunner
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import lm
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_step import make_train_step

    class Recorded(CheckpointStore):
        """The store, timing each save and restore and keeping a reference
        to each saved and restored tree (the step is functional, so a saved
        tree stays as it was saved)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.saved, self.restored = {}, []
            self.save_s, self.restore_s, self.nbytes = [], [], []

        def save(self, step, tree, *, extra=None):
            t = time.perf_counter()
            path = super().save(step, tree, extra=extra)
            self.save_s.append(time.perf_counter() - t)
            self.nbytes.append(sum(f.stat().st_size for f in path.iterdir()))
            self.saved[step] = tree
            return path

        def restore(self, template, **kw):
            t = time.perf_counter()
            tree, extra = super().restore(template, **kw)
            torch.cuda.synchronize()
            self.restore_s.append(time.perf_counter() - t)
            self.restored.append((extra.get("step"), tree))
            return tree, extra

    cfg = dataclasses.replace(registry.get(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    state = (params, adamw_init(params, opt_cfg))
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = make_train_step(cfg, opt_cfg)
    batches = synthetic_batches(cfg, TRAIN_BATCH, TRAIN_SEQ, "cuda")
    at, losses, step_s = {}, [], []

    def batch_of(step):
        at["step"] = step  # the step whose batch the runner asked for last
        return batches(step)

    def stepper(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, o, m = step_fn(*state, batch)
        loss = m["loss"].item()  # the loss before any injection replaces it
        step_s.append(time.perf_counter() - t)
        losses.append((at["step"], loss))
        return (p, o), m

    store = Recorded(ckpt_dir, keep_last=TRAIN_KEEP_LAST, n_shards=TRAIN_SHARDS)
    runner = FaultTolerantRunner(stepper, store, FaultPolicy(checkpoint_every=TRAIN_CKPT_EVERY))
    runner.inject(TRAIN_NAN_AT, "nan")
    t0 = time.perf_counter()
    state, completed, events = runner.run(state, batch_of, TRAIN_STEPS)
    run_s = time.perf_counter() - t0
    back = TRAIN_NAN_AT - TRAIN_NAN_AT % TRAIN_CKPT_EVERY
    if completed != TRAIN_STEPS or events != [FaultEvent(TRAIN_NAN_AT, "nan", "rollback")]:
        raise AssertionError(f"train: completed {completed}, events {events}")
    if not all(math.isfinite(loss) for _, loss in losses):
        raise AssertionError(f"train: a loss is not finite: {losses}")
    if [s for s, _ in store.restored] != [back] or store.committed_steps() != [TRAIN_STEPS]:
        raise AssertionError(f"train: restored {[s for s, _ in store.restored]}, committed "
                             f"{store.committed_steps()}")
    saved, restored = list(_leaves(store.saved[back])), list(_leaves(store.restored[0][1]))
    bitwise = len(saved) == len(restored) and all(
        _bitwise_equal(torch, a, b) for a, b in zip(saved, restored))
    if not bitwise:
        raise AssertionError(f"train: the state restored at step {back} differs from the saved one")
    tries = [loss for s, loss in losses if s == TRAIN_NAN_AT]
    rerun_rel = abs(tries[1] - tries[0]) / abs(tries[0])
    if len(tries) != 2 or not rerun_rel <= TRAIN_RERUN_RTOL:
        raise AssertionError(f"train: step {TRAIN_NAN_AT}'s losses {tries} (rel {rerun_rel})")
    steady = statistics.median(step_s[1:])
    out = {
        "arch": cfg.name, "params": cfg.param_count(), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": completed, "events": [vars(e) for e in events], "losses": losses,
        "init_s": init_s, "run_s": run_s, "step_s": step_s, "step_s_median": steady,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady,
        "checkpoint_bytes": store.nbytes, "save_s": store.save_s, "restore_s": store.restore_s,
        "restored_bitwise": bitwise, "rerun_loss_rel_err": rerun_rel,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    log(f"[train] {cfg.name} {completed} steps (B {TRAIN_BATCH}, S {TRAIN_SEQ}): step "
        f"{steady:.4f}s median ({out['tokens_per_s']:.0f} tokens/s), first {step_s[0]:.3f}s; "
        f"losses {[round(v, 4) for _, v in losses]}; checkpoints {store.nbytes} bytes, "
        f"save {store.save_s} s, restore {store.restore_s} s; rollback to {back} bitwise, "
        f"re-run loss rel {rerun_rel:.2e}; peak {out['peak_gib']:.2f} GiB")
    return cfg, state[0], out


def train_grad_check(torch):
    """Phase 9(b): one loss and gradient at olmo-1b's width cut to
    GRAD_LAYERS layers, fp32, on the card against the CPU (same weights and
    batch)."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import lm
    from repro_torch.training.train_step import value_and_grad

    cfg = dataclasses.replace(registry.get(TRAIN_ARCH), num_layers=GRAD_LAYERS,
                              dtype="float32", param_dtype="float32")
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(61), "cpu")
    batch = synthetic_batches(cfg, GRAD_BATCH, TRAIN_SEQ)(0)
    t0 = time.perf_counter()
    loss_c, _, g_cpu = value_and_grad(cfg, p_cpu, batch)
    cpu_s = time.perf_counter() - t0
    p_gpu = lm.params_to(p_cpu, "cuda")
    value_and_grad(cfg, p_gpu, {k: v.cuda() for k, v in batch.items()})  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_g, _, g_gpu = value_and_grad(cfg, p_gpu, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    loss_rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    worst = max((gg.cpu() - gc).abs().max().item() / max(gc.abs().max().item(), 1e-30)
                for gc, gg in zip(_leaves(g_cpu), _leaves(g_gpu)))
    out = {"layers": GRAD_LAYERS, "batch": GRAD_BATCH, "seq": TRAIN_SEQ,
           "loss_cpu": loss_c.item(), "loss_card": loss_g.item(), "loss_rel_err": loss_rel,
           "grad_max_rel_err": worst, "cpu_s": cpu_s, "card_s": card_s}
    log(f"[train] card vs CPU, {GRAD_LAYERS} layers fp32: {out}")
    if not (loss_rel <= GRAD_LOSS_RTOL and worst <= GRAD_RTOL):
        raise AssertionError(f"train: card vs CPU loss rel {loss_rel}, gradient rel {worst}")
    return out


def check_grad_refusals(torch):
    """Each CUDA kernel wrapper raises ValueError, launching nothing, on an
    input that requires grad (none has a backward)."""
    from repro_torch.kernels import ops

    kernels = kernel_table.reset_counts()
    f32 = dict(device="cuda", dtype=torch.float32)
    bf = dict(device="cuda", dtype=torch.bfloat16)

    def req(t):
        return t.requires_grad_(True)

    q = torch.randn(1, 16, 2, 64, **bf)
    cache = torch.randn(1, 32, 2, 64, **bf)
    pages = torch.randn(4, 16, 2, 64, **bf)
    table = torch.tensor([[2, 0]], device="cuda", dtype=torch.int32)
    lens = torch.tensor([20], device="cuda", dtype=torch.int32)
    r = torch.randn(1, 16, 2, 64, **f32)
    calls = {
        "flash_attention": lambda: ops.flash_attention_op(req(q.clone()), q, q),
        "decode_attention": lambda: ops.decode_attention_op(req(q[:, :1].clone()), cache,
                                                            cache, lens),
        "paged_decode_attention": lambda: ops.paged_decode_attention_op(
            q[:, :1], req(pages.clone()), pages, table, lens),
        "wkv6": lambda: ops.wkv6_op(r, r, r, -torch.rand_like(r),
                                    req(torch.randn(2, 64, **f32))),
        "ssd": lambda: ops.ssd_op(req(r.clone()), torch.rand(1, 16, 2, **f32),
                                  torch.zeros(2, **f32), r[..., 0, :], r[..., 1, :],
                                  torch.ones(2, **f32)),
        "topk_cosine": lambda: ops.resident_topk(req(torch.randn(2, 384, **f32)),
                                                 torch.randn(8, 384, **f32)),
    }
    refused = {}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            refused[name] = str(e)
        else:
            raise AssertionError(f"{name}: the CUDA wrapper took an input that requires grad")
    launched = {n: fn.launches for n, fn in kernels.items() if fn.launches}
    if launched:
        raise AssertionError(f"refused calls launched kernels: {launched}")
    return sorted(refused)


def serve_trained(torch, cfg, params):
    """Phase 9(c): the trained olmo-1b weights in an Engine (bf16): one
    prefill through the flash kernel, held against the training path's
    forward on the card, then SERVED_NEW greedy steps through the decode
    kernel; launches pinned to one a layer a call."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    kernels = kernel_table.launchers()
    eng = Engine(cfg, params, max_len=SERVED_PROMPT + SERVED_NEW + 8, device="cuda")
    prompt = np.random.RandomState(71).randint(16, min(cfg.vocab_size, 4096),
                                               (1, SERVED_PROMPT)).astype(np.int32)
    kernel_table.reset_counts()
    logits, cache = eng.prefill(prompt)
    flash_n = kernels["flash_attention"].launches
    steps = []
    tok = logits.argmax(-1, keepdim=True)
    for _ in range(SERVED_NEW):
        steps.append(int(tok.item()))
        lg, cache = eng.decode(cache, tok.cpu().numpy())
        if not torch.isfinite(lg).all():
            raise AssertionError("served: non-finite decode logits")
        tok = lg.argmax(-1, keepdim=True)
    decode_n = kernels["decode_attention"].launches
    if (flash_n, decode_n) != (cfg.num_layers, SERVED_NEW * cfg.num_layers):
        raise AssertionError(f"served: flash {flash_n}, decode {decode_n} launches, want "
                             f"{cfg.num_layers} and {SERVED_NEW * cfg.num_layers}")
    with torch.no_grad():
        want, _, _ = lm.forward(cfg, params, torch.as_tensor(prompt, device="cuda"),
                                use_kernels=False)
    want = want[:, -1].float()
    err = (logits.float() - want).abs().max().item()
    scale = want.abs().max().item()
    out = {"prompt": SERVED_PROMPT, "steps": SERVED_NEW, "tokens": steps,
           "logits_max_abs_err": err, "logits_max_abs": scale,
           "argmax_equal": int(logits.argmax()) == int(want.argmax()),
           "flash_launches": flash_n, "decode_launches": decode_n,
           "prefill_tok_s": eng.stats.rates()["prefill"],
           "decode_tok_s": eng.stats.rates()["decode"]}
    if not err <= SERVED_TOL * scale:
        raise AssertionError(f"served: prefill logits differ from the training path's by "
                             f"{err} (largest {scale})")
    out["grad_refused"] = check_grad_refusals(torch)
    log(f"[train] served: {out}")
    return out


def make_cold_store(plan_cls, dist_cls, name, cold_dir, **kw):
    """Phase 9(d)'s store ``name`` ("store/policy/threshold"): a 4-slot
    PlanCache, or 2 nodes of 4 slots at replication 1, fuzzy on the
    ``device`` index, with a cold tier."""
    kind, policy, threshold = name.split("/")
    kw = dict(eviction=policy, fuzzy=True, fuzzy_threshold=float(threshold),
              index_backend="device", **kw)
    if kind == "plan":
        return plan_cls(capacity=4, cold_dir=cold_dir, **kw)
    return dist_cls(2, replication=1, capacity_per_node=4, cold_dir=cold_dir, **kw)


def cold_stream(store):
    """Phase 9(d)'s op stream on a store with a cold tier, its outcome as
    plain data: the lookups of every key after the insert wave, each
    node's hot and cold key ids, the cold_hits / spills / promotes totals,
    then remove (twice, with a lookup between) and what clear leaves."""
    shards = ([store.shards[n] for n in sorted(store.shards)] if hasattr(store, "shards")
              else [store])
    keys = [f"key number {i}" for i in range(COLD_KEYS)]

    def ids(ks):
        return sorted(keys.index(k) for k in ks)

    store.insert_batch([(k, i) for i, k in enumerate(keys)])
    out = {"lookup": store.lookup_batch(keys),
           "hot": [ids(sh.keys()) for sh in shards],
           "cold": [ids(sh.cold.keys()) for sh in shards]}
    for f in ("cold_hits", "spills", "promotes"):
        out[f] = sum(getattr(sh.stats, f) for sh in shards)
    out["remove"] = [store.remove(keys[0]), store.lookup(keys[0]), store.remove(keys[0])]
    store.clear()
    out["cleared"] = [len(store), sum(len(sh.cold) for sh in shards),
                      store.lookup_batch(keys).count(None)]
    return out


def cold_on_card(torch, root):
    """Phase 9(d): ``cold_stream`` on the card's ``device`` index for each
    pinned (store, policy); each must equal the reference's outcome and
    launch the top-k kernel."""
    from repro_torch.core.cache import PlanCache
    from repro_torch.core.distributed_cache import DistributedPlanCache

    topk = kernel_table.launchers()["topk_cosine"]
    out = {}
    for name, want in COLD_EXPECT.items():
        topk.launches = 0
        store = make_cold_store(PlanCache, DistributedPlanCache, name,
                                os.path.join(root, name.replace("/", "_")), device="cuda")
        got = cold_stream(store)
        if got != want:
            raise AssertionError(f"cold {name}: {got}, the reference's {want}")
        if not topk.launches:
            raise AssertionError(f"cold {name}: the top-k kernel never launched")
        out[name] = {"topk_launches": topk.launches, "cold_hits": got["cold_hits"],
                     "spills": got["spills"], "promotes": got["promotes"]}
    log(f"[train] cold tier on the card: {out}")
    return out


def _sim_judge(tag, cfg, report):
    """A clean cell must show no violation, an audit cell must trip one of
    its guard's oracles; returns the oracles that fired."""
    fired = sorted({v.oracle for v in report.violations})
    if cfg.ablate:
        want = SIM_ORACLES[cfg.ablate[0]]
        if not want & set(fired):
            raise AssertionError(f"sim {tag}: guard {cfg.ablate[0]} ablated, oracles {fired} "
                                 f"fired, none of {sorted(want)}")
    elif fired:
        v = report.violations[0]
        raise AssertionError(f"sim {tag}: {len(report.violations)} violations, the first "
                             f"step {v.step} {v.oracle}: {v.detail}")
    return fired


def sim_on_card(torch):
    """Phase 10: the deterministic simulation with its similarity indexes on
    the card (SIM_* above states each check). The CPU runs the card's hashes
    are held to run in a worker process (spawned, one torch thread) while
    the card runs here. Returns the ``{"sim": ...}`` line's body."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.sim import SimConfig, run_sim
    from repro_torch.sim.__main__ import matrix_cells

    t0 = time.perf_counter()
    kernels = kernel_table.launchers()
    out = {"fuzzy": {}, "other": {}, "audit_trips": {}}
    cells = [(tag, cfg) for seed in range(SIM_SEEDS) for tag, cfg in sum(matrix_cells(seed), [])]
    soak = SimConfig(**SIM_SOAK)
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                             initializer=torch.set_num_threads, initargs=(1,)) as pool:
        on_cpu = {tag: pool.submit(run_sim, cfg, device="cpu", index_backend="device")
                  for tag, cfg in cells + [("soak", soak)] if cfg.normalized().fuzzy}
        kernel_table.reset_counts()
        hash_checks = _sim_card_cells(cells, soak, on_cpu, kernels["topk_cosine"], out)
        launches = {n: fn.launches for n, fn in kernels.items()}
    if set(n for n, v in launches.items() if v) != {"topk_cosine"}:
        raise AssertionError(f"sim: launches {launches}; only top-k is on this path")
    out.update(
        cells=len(out["fuzzy"]) + len(out["other"]) + 1, fuzzy_cells=len(out["fuzzy"]),
        violations_clean=0, hash_checks=hash_checks, topk_launches=launches["topk_cosine"],
        cold_tier_s=out["other"]["s0-evict_then_hit-cold_tier"]["s"])
    out["seconds"]["total"] = time.perf_counter() - t0
    log(f"[sim] {out['cells']} cells ({out['fuzzy_cells']} fuzzy on the card and the CPU), "
        f"{hash_checks} hash checks, {len(out['audit_trips'])} audit cells tripped, top-k "
        f"{launches['topk_cosine']} launches; soak {out['soak']['s']:.2f}s "
        f"{out['soak']['topk_launches']} launches; seconds {out['seconds']}")
    return out


def _sim_card_cells(cells, soak, on_cpu, topk, out):
    """Phase 10's runs on the card: (a), (b) and (c) of SIM_* above, each
    fuzzy run's hash held to its CPU run's (``on_cpu``: tag -> future).
    Fills ``out``; returns the number of hash checks."""
    from repro_torch.sim import run_sim

    hash_checks = 0
    t0 = time.perf_counter()
    for tag, cfg in cells:
        if not cfg.normalized().fuzzy:
            continue
        before = topk.launches
        t = time.perf_counter()
        a = run_sim(cfg, device="cuda")
        card_s = time.perf_counter() - t
        launched = topk.launches - before
        b = run_sim(cfg, device="cuda")
        cpu = on_cpu[tag].result()
        if a.index_backend != "device" or not launched:
            raise AssertionError(f"sim {tag}: index {a.index_backend}, {launched} top-k launches")
        if (a.trace_hash, a.span_digest) != (b.trace_hash, b.span_digest):
            raise AssertionError(f"sim {tag}: nondeterministic on the card: "
                                 f"{(a.trace_hash, a.span_digest)} then "
                                 f"{(b.trace_hash, b.span_digest)}")
        if a.trace_hash != cpu.trace_hash:
            raise AssertionError(f"sim {tag}: card hash {a.trace_hash}, CPU {cpu.trace_hash}; "
                                 f"last card events {a.trace_tail[-3:]}")
        hash_checks += 2
        fired = _sim_judge(tag, cfg, a)
        if cfg.ablate:
            out["audit_trips"][tag] = fired
        out["fuzzy"][tag] = {"trace_hash": a.trace_hash, "topk_launches": launched,
                             "violations": len(a.violations), "card_s": card_s}
    fuzzy_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    for tag, cfg in cells:
        if cfg.seed != 0 or cfg.normalized().fuzzy:
            continue
        t = time.perf_counter()
        r = run_sim(cfg, device="cuda")
        want = SIM_REF_HASHES[tag[len("s0-"):]]
        if r.trace_hash != want:
            raise AssertionError(f"sim {tag}: trace hash {r.trace_hash}, the reference's {want}")
        hash_checks += 1
        fired = _sim_judge(tag, cfg, r)
        if cfg.ablate:
            out["audit_trips"][tag] = fired
        out["other"][tag] = {"violations": len(r.violations), "s": time.perf_counter() - t}
    other_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    before = topk.launches
    a = run_sim(soak, device="cuda")
    soak_s = time.perf_counter() - t2
    soak_launches = topk.launches - before
    b = run_sim(soak, device="cuda")
    cpu = on_cpu["soak"].result()
    _sim_judge("soak", soak, a)
    if not soak_launches or len({a.trace_hash, b.trace_hash, cpu.trace_hash}) != 1 \
            or a.span_digest != b.span_digest:
        raise AssertionError(f"sim soak: launches {soak_launches}, hashes card "
                             f"{(a.trace_hash, a.span_digest)}, {(b.trace_hash, b.span_digest)}, "
                             f"CPU {cpu.trace_hash}")
    out.update(soak={**SIM_SOAK, "s": soak_s, "topk_launches": soak_launches, "steps": a.steps,
                     "lookups": a.lookups, "trace_hash": a.trace_hash},
               seconds={"fuzzy": fuzzy_s, "other": other_s,
                        "soak": time.perf_counter() - t2})
    return hash_checks + 2


def check_outputs(torch, engines):
    """What comes out is right: finite logits of the expected shape on
    every engine."""
    import numpy as np

    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.envs.workloads import get_env

    task = get_env("financebench").generate(1, seed=0)[0]
    tok = np.asarray([HashTokenizer().encode(task.query)], np.int32)
    for e in {id(e): e for e in engines.values()}.values():
        logits, _ = e.prefill(tok)
        if tuple(logits.shape) != (1, e.cfg.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"serve: {e.cfg.name} logits {tuple(logits.shape)} not finite")


def free_memory(torch):
    """Return the card memory of objects the caller dropped: the engines sit
    in reference cycles (agent, backend, caches), which only the garbage
    collector frees, then the allocator's cache."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def multi_prompts():
    """(MULTI_PROMPTS FinanceBench queries right-padded, (1,
    MULTI_PROMPT_LEN) of the queries run together), as int32 arrays."""
    import numpy as np

    from repro_torch.data.tokenizer import PAD, HashTokenizer
    from repro_torch.envs.workloads import get_env

    tok = HashTokenizer()
    tasks = get_env("financebench").generate(N_TASKS, seed=0)
    ids = [tok.encode(t.query) for t in tasks]
    width = max(len(i) for i in ids[:MULTI_PROMPTS])
    batch = np.full((MULTI_PROMPTS, width), PAD, np.int32)
    for r, i in enumerate(ids[:MULTI_PROMPTS]):
        batch[r, :len(i)] = i
    run = [x for i in ids for x in i][:MULTI_PROMPT_LEN]
    if len(run) < MULTI_PROMPT_LEN:
        raise AssertionError(f"multi: the queries give {len(run)} tokens, not {MULTI_PROMPT_LEN}")
    return batch, np.asarray([run], np.int32)


def multi_prefix_prompts(long_prompt):
    """MULTI_PREFIX_ROWS rows of one template (the long prompt's first
    MULTI_PREFIX_LEN tokens) and a MULTI_PREFIX_SUFFIX-token suffix each (the
    prompt's next tokens, rotated by the row)."""
    import numpy as np

    tpl = long_prompt[0, :MULTI_PREFIX_LEN]
    tail = long_prompt[0, MULTI_PREFIX_LEN:MULTI_PREFIX_LEN + MULTI_PREFIX_SUFFIX]
    return np.stack([np.concatenate([tpl, np.roll(tail, r)])
                     for r in range(MULTI_PREFIX_ROWS)]).astype(np.int32)


def _greedy(torch, eng, prompts, n, forced=None, prefix_len=0):
    """Prefill and n - 1 decode steps: (tokens (B, n), logits (n, B, V) fp32
    on the host). ``forced`` (B, n) feeds those tokens instead of the
    argmax (teacher forcing), so that logits compare step by step. With
    ``prefix_len`` the prefill that starts it is the KV prefix path's: a
    full prefill registers the first ``prefix_len`` positions in the
    engine's pool, and the suffix-only prefill from the pool follows."""
    import numpy as np

    if prefix_len:
        _, cache = eng.prefill(prompts)
        if not eng.register_prefix("tpl", cache, prefix_len):
            raise AssertionError("multi: the template prefix did not register")
        del cache
        res = eng.prefill_with_prefix("tpl", prompts[:, prefix_len:], expected_len=prefix_len)
        if res is None:
            raise AssertionError("multi: the registered prefix missed")
        logits, cache = res
    else:
        logits, cache = eng.prefill(prompts)
    toks, outs = [], [logits.float().cpu()]
    for i in range(n):
        tok = logits.argmax(-1).cpu().numpy()[:, None].astype(np.int32)
        toks.append(tok)
        if i + 1 == n:
            break
        feed = tok if forced is None else forced[:, i:i + 1]
        logits, cache = eng.decode(cache, feed)
        outs.append(logits.float().cpu())
    return np.concatenate(toks, 1), torch.stack(outs)


def multi_nccl(rank, world):
    """Phase 11(a)'s body, one NCCL rank at world size 1 in a process of its
    own (module constants). Returns (its record, (b)'s unsharded
    references: the 152-token prompt, its greedy tokens and logits)."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed import mesh_compat as mc
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.serve import arch_seed, engine_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_cache import KVPrefixCache, pool_for_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lmesh.phase("nccl")
    t0 = time.perf_counter()
    kernels = kernel_table.launchers()
    cfg = engine_config(MULTI_ARCH, full=True)
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        arch_seed(MULTI_ARCH)), "cuda")
    batch, long_prompt = multi_prompts()
    max_len = MULTI_PROMPT_LEN + MULTI_NEW + 8
    mesh = lmesh.make_mesh((1, 1), ("data", "model"))
    engines = {"plain": Engine(cfg, params, max_len=max_len, device="cuda"),
               "mesh": Engine(cfg, params, mesh=mesh, max_len=max_len, device="cuda",
                              profile=registry.get_sharding(MULTI_ARCH))}
    torch.cuda.synchronize()
    split = {"build": time.perf_counter() - t0}
    got = {}
    for name, eng in engines.items():
        kernel_table.reset_counts()
        mc.reset_counters()
        toks, logits = _greedy(torch, eng, batch, MULTI_NEW)
        gen = eng.generate(batch, MULTI_NEW)
        torch.cuda.synchronize()
        got[name] = {"tokens": toks, "logits": logits, "generate": gen,
                     "launches": {n: kernels[n].launches
                                  for n in ("flash_attention", "decode_attention")},
                     "collectives": {k: dict(v) for k, v in mc.COUNTERS.items()}}
    plain, sharded = got["plain"], got["mesh"]
    if not (np.array_equal(plain["tokens"], sharded["tokens"])
            and torch.equal(plain["logits"], sharded["logits"])
            and np.array_equal(plain["generate"], sharded["generate"])):
        d = float((plain["logits"] - sharded["logits"]).abs().max())
        raise AssertionError(f"multi(a): Engine(mesh=) at world 1 differs: |dlogit| {d}")
    if plain["launches"] != sharded["launches"] or not all(plain["launches"].values()):
        raise AssertionError(f"multi(a): launches {plain['launches']} vs "
                             f"{sharded['launches']}")
    nccl = sharded["collectives"]
    if mesh.backend != "nccl" or not (nccl["psum"]["calls"] and nccl["all_gather"]["calls"]):
        raise AssertionError(f"multi(a): backend {mesh.backend}, collectives {nccl}")
    # the FSDP gather's backward on NCCL: one reduce-scatter, here over one
    # rank, so the gradient comes back unchanged
    mc.reset_counters()
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(8, 16, generator=gen, device="cuda").requires_grad_(True)
    w = torch.randn(8, 16, generator=gen, device="cuda")
    with torch.enable_grad():
        (gx,) = torch.autograd.grad((mc.all_gather(x, mesh, "data") * w).sum(), [x])
    rs = dict(mc.COUNTERS["reduce_scatter"])
    if not (torch.equal(gx, w) and rs["calls"] == 1 and rs["staged_bytes"] == 0):
        raise AssertionError(f"multi(a): the gather's backward on NCCL: {rs}, "
                             f"|dg| {float((gx - w).abs().max())}")
    ref_toks, ref_logits = _greedy(torch, engines["plain"], long_prompt, MULTI_NEW)
    del engines
    torch.cuda.empty_cache()
    split["serve"] = time.perf_counter() - t0 - split["build"]
    # the KV prefix path: Engine(mesh=, kv_prefix=) against Engine(kv_prefix=)
    prefix_prompts = multi_prefix_prompts(long_prompt)
    prof = registry.get_sharding(MULTI_ARCH)
    got = {}
    for name, kw in (("plain", {}), ("mesh", {"mesh": mesh, "profile": prof})):
        kv = KVPrefixCache(pool_for_config(cfg, num_pages=MULTI_PREFIX_PAGES,
                                           page_size=MULTI_PREFIX_PAGE, device="cuda", **kw))
        eng = Engine(cfg, params, max_len=max_len, device="cuda", kv_prefix=kv, **kw)
        kernel_table.reset_counts()
        toks, logits = _greedy(torch, eng, prefix_prompts, MULTI_NEW,
                               prefix_len=MULTI_PREFIX_LEN)
        torch.cuda.synchronize()
        got[name] = {"tokens": toks, "logits": logits, "reused": eng.stats.prefix_tokens_reused,
                     "launches": {n: kernels[n].launches
                                  for n in ("flash_attention", "decode_attention")},
                     "pool": (kv.pool.nbytes, kv.pages_built, kv.pages_hit)}
        del eng, kv
        torch.cuda.empty_cache()
    plain, sharded = got["plain"], got["mesh"]
    if not (np.array_equal(plain["tokens"], sharded["tokens"])
            and torch.equal(plain["logits"], sharded["logits"])
            and plain["launches"] == sharded["launches"] and plain["pool"] == sharded["pool"]
            and plain["reused"] == sharded["reused"] == MULTI_PREFIX_ROWS * MULTI_PREFIX_LEN):
        d = float((plain["logits"] - sharded["logits"]).abs().max())
        raise AssertionError(f"multi(a): Engine(mesh=, kv_prefix=) at world 1 differs: "
                             f"|dlogit| {d}, launches {plain['launches']} vs "
                             f"{sharded['launches']}, pools {plain['pool']} vs {sharded['pool']}")
    L = cfg.num_layers
    if plain["launches"] != {"flash_attention": L, "decode_attention": L * (MULTI_NEW - 1)}:
        raise AssertionError(f"multi(a): prefix path launches {plain['launches']}")
    rec = {"backend": mesh.backend, "world": 1, "mesh": [1, 1], "arch": MULTI_ARCH,
           "prompts": list(batch.shape), "new": MULTI_NEW, "bitwise": True,
           "launches": sharded["launches"], "reduce_scatter": rs,
           "collectives": {k: v for k, v in nccl.items() if v["calls"]},
           "prefix": {"prompts": list(prefix_prompts.shape), "prefix_len": MULTI_PREFIX_LEN,
                      "bitwise": True, "launches": plain["launches"],
                      "prefix_tokens_reused": plain["reused"], "pool_bytes": plain["pool"][0]},
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "split": {**split, "prefix": time.perf_counter() - t0 - sum(split.values())},
           "seconds": time.perf_counter() - t0}
    return rec, {"prompt": long_prompt, "tokens": ref_toks, "logits": ref_logits.numpy(),
                 "prefix_prompts": prefix_prompts, "prefix_tokens": plain["tokens"],
                 "prefix_logits": plain["logits"].numpy(), "pool_bytes": plain["pool"][0]}


def _head_probe(torch, ops):
    """Wrap the attention ops to record the (q heads, kv heads) of each call
    and to hold its output to the plain version on the same inputs: the
    largest |kernel - plain| / max(1, max |plain|) of each kernel, a 0-d
    device tensor (no sync a call; a decode row of length 0 is left out,
    where the plain version averages v). Returns (heads, errors, undo)."""
    from repro_torch.kernels import ref

    seen = {"flash_attention": collections.Counter(), "decode_attention": collections.Counter()}
    errs = {}
    orig = {"flash_attention": ops.flash_attention_op, "decode_attention": ops.decode_attention_op}

    def plain(name, q, k, v, *a, **kw):
        if name == "flash_attention":
            return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), **kw).transpose(1, 2), None
        lens = torch.as_tensor(a[0], device=q.device).reshape(-1).expand(q.shape[0])
        return ref.decode_attention_ref(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                                        lens)[:, None], lens > 0

    def wrap(name):
        def call(q, k, *a, **kw):
            seen[name][(q.shape[2], k.shape[2])] += 1
            o = orig[name](q, k, *a, **kw)
            r, live = plain(name, q, k, *a, **kw)
            d = (o.float() - r.float()).abs()
            if live is not None:
                d = d[live]
            e = d.max() / r.float().abs().max().clamp(min=1.0)
            errs[name] = torch.maximum(errs[name], e) if name in errs else e
            return o
        return call

    ops.flash_attention_op = wrap("flash_attention")
    ops.decode_attention_op = wrap("decode_attention")

    def undo():
        ops.flash_attention_op = orig["flash_attention"]
        ops.decode_attention_op = orig["decode_attention"]

    return seen, errs, undo


def await_ref(ref_dir):
    """(a)'s unsharded references for (b)'s ranks: ``ref.npz``, which the
    parent writes into ``ref_dir`` once (a) has returned (or ``failed``
    where (a) raised)."""
    import numpy as np

    path = os.path.join(ref_dir, "ref.npz")
    deadline = time.monotonic() + MULTI_TIMEOUT_S
    while not os.path.exists(path):
        if os.path.exists(os.path.join(ref_dir, "failed")) or time.monotonic() > deadline:
            raise RuntimeError("multi(b): phase 11(a) gave no references")
        time.sleep(0.05)
    with np.load(path) as z:
        return {k: z[k] if z[k].ndim else z[k].item() for k in z.files}


def multi_rank(rank, world, ref_dir):
    """Phase 11(b)'s body on each of the four gloo ranks sharing the card
    (module constants state each check), on (a)'s references from
    ``ref_dir``; returns the rank's record."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.distributed import mesh_compat as mc
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.elastic import reshard_tree
    from repro_torch.distributed.pipeline import pipeline_apply, sequential_reference
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.serve import arch_seed, engine_config
    from repro_torch.models import lm, moe
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kv_cache import KVPrefixCache, pool_for_config
    from repro_torch.training.grad_compress import compressed_allreduce, ef_state_init
    from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
    from repro_torch.training.train_step import make_train_step, reduce_grads, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    kernels = kernel_table.launchers()
    out = {"device": str(torch.cuda.current_device()), "seconds": {}, "checks": {},
           "errors": {}, "split": {}, "t_start": time.time()}

    def lap(key, t):
        """Adds the seconds since ``t`` to split[key]; returns now."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        out["split"][key] = out["split"].get(key, 0.0) + now - t
        return now

    t = time.perf_counter()
    ref = await_ref(ref_dir)
    out["ref_wait_s"] = time.perf_counter() - t

    def gen(arch):
        return torch.Generator(device="cuda").manual_seed(arch_seed(arch))

    def timed(name):
        lmesh.phase(name)
        torch.cuda.synchronize()
        out["seconds"][name] = -time.perf_counter()

    def stop(name):
        torch.cuda.synchronize()
        out["seconds"][name] += time.perf_counter()

    mc.reset_counters()
    # tp_serve
    timed("tp_serve")
    t = time.perf_counter()
    mesh = lmesh.make_mesh((1, 4), ("data", "model"))
    cfg = engine_config(MULTI_ARCH, full=True)
    eng = Engine(cfg, lm.init_params(cfg, gen(MULTI_ARCH), "cuda"), mesh=mesh,
                 profile=registry.get_sharding(MULTI_ARCH), device="cuda",
                 max_len=MULTI_PROMPT_LEN + MULTI_NEW + 8)
    torch.cuda.empty_cache()
    t = lap("serve.build", t)
    seen, kerr, undo = _head_probe(torch, ops)
    kernel_table.reset_counts()
    try:
        _, logits = _greedy(torch, eng, ref["prompt"], MULTI_NEW, forced=ref["tokens"])
        launches = {n: kernels[n].launches for n in ("flash_attention", "decode_attention")}
        t = lap("serve.greedy", t)
        free = eng.generate(ref["prompt"], MULTI_NEW)
        t = lap("serve.generate", t)
    finally:
        undo()
    ref_l = torch.from_numpy(ref["logits"])
    err = float((logits - ref_l).abs().max() / ref_l.abs().max())
    L = cfg.num_layers
    want = {"flash_attention": L, "decode_attention": L * (MULTI_NEW - 1)}
    local = (cfg.num_heads // 4, cfg.num_kv_heads // 4)
    heads = {n: dict((f"{q}/{k}", c) for (q, k), c in s.items()) for n, s in seen.items()}
    kerr = {n: float(e) for n, e in kerr.items()}
    tol = TOL[cfg.dtype]
    out["errors"]["tp_serve"] = err
    out["errors"]["tp_kernels_vs_plain"] = kerr
    out["checks"]["tp_serve"] = {
        "launches": launches, "predicted": want, "heads": heads,
        "kernel_vs_plain": kerr, "kernel_tol": tol,
        "tokens_matching": int((free == ref["tokens"]).sum()), "tokens": int(free.size),
        "ok": (err <= MULTI_TP_TOL and launches == want
               and set(kerr) == {"flash_attention", "decode_attention"}
               and all(e <= tol for e in kerr.values())
               and set(heads["flash_attention"]) == {f"{local[0]}/{local[1]}"}
               and set(heads["decode_attention"]) == {f"{local[0]}/{local[1]}"})}
    del eng
    torch.cuda.empty_cache()
    stop("tp_serve")

    # tp_prefix: the KV prefix path on (1, 4), each rank over its own pool
    timed("tp_prefix")
    prof = registry.get_sharding(MULTI_ARCH)
    kv = KVPrefixCache(pool_for_config(cfg, num_pages=MULTI_PREFIX_PAGES,
                                       page_size=MULTI_PREFIX_PAGE, device="cuda", mesh=mesh,
                                       profile=prof))
    eng = Engine(cfg, lm.init_params(cfg, gen(MULTI_ARCH), "cuda"), mesh=mesh, profile=prof,
                 device="cuda", max_len=MULTI_PROMPT_LEN + MULTI_NEW + 8, kv_prefix=kv)
    torch.cuda.empty_cache()
    seen, kerr, undo = _head_probe(torch, ops)
    kernel_table.reset_counts()
    try:
        _, logits = _greedy(torch, eng, ref["prefix_prompts"], MULTI_NEW,
                            forced=ref["prefix_tokens"], prefix_len=MULTI_PREFIX_LEN)
        launches = {n: kernels[n].launches for n in ("flash_attention", "decode_attention")}
    finally:
        undo()
    ref_l = torch.from_numpy(ref["prefix_logits"])
    err = float((logits - ref_l).abs().max() / ref_l.abs().max())
    want = {"flash_attention": L, "decode_attention": L * (MULTI_NEW - 1)}
    heads = {n: dict((f"{q}/{k}", c) for (q, k), c in s.items()) for n, s in seen.items()}
    kerr = {n: float(e) for n, e in kerr.items()}
    # the paged kernel over the rank's pool, at its local heads
    kernel_table.reset_counts()
    paged = paged_over_pool(torch, kv, dataclasses.replace(cfg, num_heads=local[0]), ["tpl"],
                            seed=17)
    paged_launches = kernels["paged_decode_attention"].launches
    share = kv.pool.nbytes / ref["pool_bytes"]
    out["errors"]["tp_prefix"] = err
    out["checks"]["tp_prefix"] = {
        "launches": launches, "predicted": want, "heads": heads, "kernel_vs_plain": kerr,
        "paged_checks": paged, "paged_launches": paged_launches, "pool_bytes": kv.pool.nbytes,
        "pool_share": share, "prefix_tokens_reused": eng.stats.prefix_tokens_reused,
        "ok": (err <= MULTI_TP_TOL and launches == want and paged == L
               and paged_launches == L and share == 0.25
               and eng.stats.prefix_tokens_reused == MULTI_PREFIX_ROWS * MULTI_PREFIX_LEN
               and set(kerr) == {"flash_attention", "decode_attention"}
               and all(e <= tol for e in kerr.values())
               and set(heads["flash_attention"]) == {f"{local[0]}/{local[1]}"}
               and set(heads["decode_attention"]) == {f"{local[0]}/{local[1]}"})}
    del eng, kv
    torch.cuda.empty_cache()
    stop("tp_prefix")

    # ep
    timed("ep")
    base = engine_config(MULTI_EP_ARCH, full=True)
    cfg = dataclasses.replace(base, num_layers=MULTI_EP_LAYERS, dtype="float32",
                              param_dtype="float32",
                              moe=dataclasses.replace(base.moe, mode="ep", capacity_factor=8.0))
    params = lm.init_params(cfg, gen(MULTI_EP_ARCH), "cuda")
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(16, cfg.vocab_size, MULTI_EP_BATCH).astype(np.int32))
    toks = toks.cuda()
    want = lm.prefill(cfg, params, toks)[0] if rank == 0 else None
    prof = registry.get_sharding(MULTI_EP_ARCH)
    ctx = lm.ParallelCtx.from_profile(mesh, prof)
    local_p = shd.shard_tree(params, shd.param_pspecs(params, prof, mesh), mesh)
    del params
    moe.moe_forward_ep.dropped = 0
    got = lm.prefill(cfg, local_p, toks, ctx=ctx)[0]
    dropped8 = int(moe.moe_forward_ep.dropped)
    cfg125 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    moe.moe_forward_ep.dropped = 0
    lm.prefill(cfg125, local_p, toks, ctx=ctx)
    dropped = int(moe.moe_forward_ep.dropped)
    pairs = MULTI_EP_BATCH[0] * MULTI_EP_BATCH[1] * cfg.moe.experts_per_token * MULTI_EP_LAYERS
    rec = {"experts_a_rank": cfg.moe.num_experts // 4, "dropped_cf8": dropped8,
           "dropped_cf1.25": dropped, "pairs": pairs}
    if rank == 0:
        out["errors"]["ep"] = float((got - want).abs().max() / want.abs().max())
        rec["ok"] = out["errors"]["ep"] <= MULTI_EP_TOL and dropped8 == 0
    else:
        rec["ok"] = dropped8 == 0
    out["checks"]["ep"] = rec
    del local_p, got, want
    torch.cuda.empty_cache()
    stop("ep")

    # train
    timed("train")
    cfg = dataclasses.replace(engine_config(MULTI_ARCH, full=True),
                              num_layers=MULTI_TRAIN_LAYERS, dtype="float32",
                              param_dtype="float32")
    params = lm.init_params(cfg, gen(MULTI_ARCH), "cuda")
    B, S1 = MULTI_TRAIN_BATCH
    seq = torch.from_numpy(np.random.default_rng(12).integers(
        16, cfg.vocab_size, (B, S1)).astype(np.int64)).cuda()
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    opt_cfg = AdamWConfig(lr=1e-3)
    one = None
    t = time.perf_counter()
    if rank == 0:
        p1, _, m1 = make_train_step(cfg, opt_cfg)(params, adamw_init(params, opt_cfg), batch)
        g1 = value_and_grad(cfg, params, batch)[2]
        one = (float(m1["loss"]), tree_leaves(p1), tree_leaves(g1))
        del p1, g1
    t = lap("train.one_rank", t)
    mesh22 = lmesh.make_mesh((2, 2), ("data", "model"))
    rec = {}
    serving = registry.get_sharding(MULTI_ARCH)
    for name, prof in (("serve", serving), ("train", registry.get_sharding(MULTI_ARCH, "train")),
                       ("seq_parallel", dataclasses.replace(serving, seq_parallel=True)),
                       ("remat_dots", dataclasses.replace(serving, remat="dots"))):
        ctx = lm.ParallelCtx.from_profile(mesh22, prof)
        specs = shd.param_pspecs(params, prof, mesh22)
        local_p = shd.shard_tree(params, specs, mesh22)
        b = ctx.mesh.axis_size(ctx.dp)
        i = ctx.mesh.axis_index(ctx.dp)
        lb = {k: v[i * B // b:(i + 1) * B // b] for k, v in batch.items()}
        # the step's parts on the shards: its gradients and their norm, and
        # AdamW on the shards from them, which the step must equal bit for
        # bit (the two profiles the serving and training paths run; the
        # seq_parallel and remat "dots" layouts are held by their parts)
        loss, _, g_sh = value_and_grad(cfg, local_p, lb, ctx)
        g_sh, gnorm = reduce_grads(ctx, specs, g_sh)
        new = adamw_update(local_p, g_sh, adamw_init(local_p, opt_cfg), opt_cfg, gnorm=gnorm)[0]
        t = lap(f"{name}.parts", t)
        same = None
        if name in ("serve", "train"):
            new2, _, m = make_train_step(cfg, opt_cfg, ctx)(local_p,
                                                            adamw_init(local_p, opt_cfg), lb)
            same = all(torch.equal(a, b) for a, b in zip(tree_leaves(new2), tree_leaves(new)))
            loss = m["loss"]
            del new2
            t = lap(f"{name}.step", t)
        whole = shd.unshard_tree(new, specs, mesh22)
        grads = shd.unshard_tree(g_sh, specs, mesh22)
        t = lap(f"{name}.gather", t)
        rec[name] = {"loss": float(loss), "step_is_its_parts": same}
        if rank == 0:
            # one-rank AdamW on the gathered sharded gradients and norm: the
            # sharded update must equal it bit for bit (elementwise, the same
            # operations), whatever |g|
            exact = adamw_update(params, grads, adamw_init(params, opt_cfg), opt_cfg,
                                 gnorm=gnorm)[0]
            d_upd = max(float((a - b).abs().max())
                        for a, b in zip(tree_leaves(whole), tree_leaves(exact)))
            del exact
            dl = abs(rec[name]["loss"] - one[0])
            dg = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                     for a, b in zip(tree_leaves(grads), one[2]))
            dp_cond, dp_all = 0.0, 0.0
            for a, b, g in zip(tree_leaves(whole), one[1], one[2]):
                d = (a - b).abs()
                dp_all = max(dp_all, float(d.max()))
                cond = g.abs() >= MULTI_TRAIN_GMIN
                if bool(cond.any()):
                    dp_cond = max(dp_cond, float(d[cond].max()))
            rec[name].update(loss_diff=dl, grad_rel_diff=dg, param_diff=dp_cond,
                             param_diff_all=dp_all, update_vs_one_rank_adamw=d_upd)
            out["errors"][f"train_{name}"] = {"loss": dl, "grad_rel": dg, "param": dp_cond,
                                              "param_all": dp_all, "update": d_upd}
        t = lap(f"{name}.compare", t)
        del new, whole, grads, g_sh
    keep_specs = shd.param_pspecs(params, registry.get_sharding(MULTI_ARCH), mesh22)
    keep = shd.shard_tree(params, keep_specs, mesh22)
    rec["ok"] = all(rec[n]["step_is_its_parts"] for n in ("serve", "train")) and (
        rank != 0 or all(
            max(rec[n]["loss_diff"], rec[n]["grad_rel_diff"], rec[n]["param_diff"])
            <= MULTI_TRAIN_TOL and rec[n]["update_vs_one_rank_adamw"] == 0.0
            for n in ("serve", "train", "seq_parallel", "remat_dots")))
    out["checks"]["train"] = rec
    torch.cuda.empty_cache()
    stop("train")

    # pipeline
    timed("pipeline")
    Lp, Dp, Bp = MULTI_PIPE
    prng = np.random.default_rng(13)
    ws = torch.from_numpy((prng.standard_normal((Lp, Dp, Dp)) * 0.05).astype(np.float32)).cuda()
    xp = torch.from_numpy(prng.standard_normal((Bp, Dp)).astype(np.float32)).cuda()
    pmesh = lmesh.make_mesh((4,), ("pipe",))

    def layer_fn(w, h):
        return torch.tanh(h @ w) + h

    y = pipeline_apply(layer_fn, ws, xp, mesh=pmesh, axis="pipe", n_microbatches=4)
    wl = ws.clone().requires_grad_(True)
    ws2 = ws.clone().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(torch.sum(pipeline_apply(
            layer_fn, wl, xp, mesh=pmesh, axis="pipe", n_microbatches=4) ** 2), [wl])
        (gs,) = torch.autograd.grad(torch.sum(sequential_reference(layer_fn, ws2, xp) ** 2),
                                    [ws2])
    g = mc.psum(g, pmesh, "pipe")
    ys = sequential_reference(layer_fn, ws, xp)
    ef = float((y - ys).abs().max() / ys.abs().max().clamp(min=1))
    eg = float((g - gs).abs().max() / gs.abs().max().clamp(min=1))
    out["errors"]["pipeline"] = {"forward": ef, "gradient": eg}
    out["checks"]["pipeline"] = {"ok": ef < 1e-5 and eg < 1e-3}
    stop("pipeline")

    # allreduce
    timed("allreduce")
    dmesh = lmesh.make_mesh((4,), ("data",))
    grads = np.random.default_rng(14).standard_normal((4, MULTI_AR_N)).astype(np.float32)
    g_cpu = torch.from_numpy(grads[rank:rank + 1])
    ef0 = ef_state_init({"w": g_cpu})
    red_cpu, ef_cpu = compressed_allreduce({"w": g_cpu}, ef0, dmesh, "data")
    red_gpu, ef_gpu = compressed_allreduce({"w": g_cpu.cuda()},
                                           {"w": ef0["w"].cuda()}, dmesh, "data")
    mean = torch.from_numpy(grads.mean(0, keepdims=True))
    rel = float((red_cpu["w"] - mean).abs().max() / mean.abs().max())
    same = (torch.equal(red_gpu["w"].cpu(), red_cpu["w"])
            and torch.equal(ef_gpu["w"].cpu(), ef_cpu["w"]))
    out["errors"]["allreduce"] = rel
    out["checks"]["allreduce"] = {"cuda_equals_cpu": same, "ok": same and rel < 0.02}
    stop("allreduce")

    # reshard
    timed("reshard")
    mesh12 = mc.Mesh((1, 2), ("data", "model"), ranks=[0, 1], device="cuda")
    prof = registry.get_sharding(MULTI_ARCH)
    moved = reshard_tree(keep, mesh12, prof, old_mesh=mesh22, old_specs=keep_specs)
    rec = {"ok": True}
    if mesh12.member:
        back = shd.unshard_tree(moved, shd.param_pspecs(params, prof, mesh12), mesh12)
        rec["ok"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                           tree_leaves(back)))
    out["checks"]["reshard"] = rec
    stop("reshard")
    out["collectives"] = {k: dict(v) for k, v in mc.COUNTERS.items()}
    out["backend"] = mesh.backend
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["t_end"] = time.time()
    return out


DRYRUN_PROBE = r"""
import json, sys, time
import torch
from repro_torch.launch import dryrun, roofline
t0 = time.perf_counter()
device = sys.argv[3]
if device == "cuda":
    torch.empty(1, device="cuda")  # the CUDA context before the card lock is free
rows = []
for arch, shape, mesh in json.loads(sys.argv[2]):
    rec = dryrun.run_cell(arch, shape, mesh, results=sys.argv[1], device=device)
    row = {"cell": [arch, shape, mesh], "ok": rec["ok"], "error": rec.get("error"),
           "seconds": rec["total_s"]}
    if rec["ok"]:
        r = roofline.analyze_cell(f"{sys.argv[1]}/{arch}__{shape}__{mesh}.json")
        row.update({k: r[k] for k in ("meta_flops", "collective_bytes", "compute_s",
                                      "memory_s", "collective_s", "dominant", "fits_hbm_80g",
                                      "fits_hbm_80g_est")})
        mem = rec["memory"]
        row["argument_bytes"] = mem["argument_bytes"]
        if device == "cuda":
            row.update({k: mem.get(k) for k in ("peak_bytes", "base_bytes", "temp_bytes",
                                                "launches", "measured_on", "oom")})
            row["card_s"] = rec.get("card_s")
    rows.append(row)
print(json.dumps({"torch": torch.__version__, "cells": rows,
                  "seconds": time.perf_counter() - t0}))
"""


def start_dryrun(cells, device="meta", out=None):
    """A dry-run of ``cells`` in a process of its own: on the host's CPU (no
    card: CUDA_VISIBLE_DEVICES is empty) with ``device="meta"``; with
    ``"cuda"`` each cell's memory also measured on the card once its lock
    (``dryrun.card_lock`` on the records' directory) is free. Returns
    (process, its records' directory: ``out`` or a new one)."""
    import tempfile

    out = out or tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    if device == "meta":
        env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_PROBE, out, json.dumps(cells), device],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, out


def finish_dryrun(proc, out, cells):
    """Wait for ``start_dryrun``'s process (killed past MULTI_TIMEOUT_S) and
    read its cells; every cell must have run."""
    import shutil

    try:
        stdout, stderr = proc.communicate(timeout=MULTI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(out, ignore_errors=True)
    if proc.returncode != 0:
        raise AssertionError(f"multi: the dry-run exited {proc.returncode}: {stderr[-3000:]}")
    got = json.loads(stdout.strip().splitlines()[-1])
    bad = [c for c in got["cells"] if not c["ok"]]
    if bad or len(got["cells"]) != len(cells):
        raise AssertionError(f"multi: dry-run cells failed: {bad}")
    return got


def check_card_dryrun(card):
    """Phase 11(c): every cell measured on the card, with temporaries, inside
    80 GB, and the path's kernel launched once a layer (no kernel in the
    train step)."""
    from repro_torch.configs import registry
    from repro_torch.launch.roofline import HBM_BYTES

    for c in card["cells"]:
        arch, shape, _ = c["cell"]
        if not (not c["oom"] and c["temp_bytes"] > 0 and c["peak_bytes"] <= HBM_BYTES
                and c["fits_hbm_80g"] is True):
            raise AssertionError(f"multi(c): {c['cell']} on the card: {c}")
        want = {k: 0 for k in c["launches"]}
        if shape in CARD_DRYRUN_KERNEL:
            want[CARD_DRYRUN_KERNEL[shape]] = registry.get(arch).num_layers
        if c["launches"] != want:
            raise AssertionError(f"multi(c): {c['cell']} launched {c['launches']}, "
                                 f"expected {want}")


def multi_on_card(torch):
    """Phase 11: (a) one NCCL rank at world size 1; (b) four gloo ranks
    sharing the card (module constants), a dry-run on the host's CPU beside
    them; each in processes of its own (``spawn_local``), killed at a
    sub-phase's timeout; (c) the dry-run's memory on the card, its meta
    cells beside (a) and its card runs after (a). Every process starts
    first, since each takes seconds to reach the card: (b)'s ranks start
    beside (a) and wait for its references (``await_ref``). Returns the
    ``{"multi": ...}`` line's body."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import numpy as np

    from repro_torch.launch.dryrun import card_lock
    from repro_torch.launch.mesh import spawn_local

    t0 = time.perf_counter()
    dr_proc, dr_out = start_dryrun(MULTI_DRYRUN_CELLS)
    card_out, card_proc = tempfile.mkdtemp(prefix="chip_smoke_dryrun_"), None
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_ref_")
    try:
        with ThreadPoolExecutor(1) as pool:
            spawned = time.time()
            ranks_f = pool.submit(spawn_local, multi_rank, 4, backend="gloo", device="cuda",
                                  args=(ref_dir,), timeout_s=MULTI_TIMEOUT_S,
                                  phase_timeout_s=MULTI_PHASE_TIMEOUT_S)
            try:
                # (c) runs its meta cells beside (a); its card runs wait on
                # this lock until (a) has returned
                with card_lock(Path(card_out)):
                    card_proc, _ = start_dryrun(CARD_DRYRUN_CELLS, "cuda", card_out)
                    [(nccl, ref)] = spawn_local(multi_nccl, 1, backend="nccl", device="cuda",
                                                timeout_s=MULTI_TIMEOUT_S,
                                                phase_timeout_s=MULTI_PHASE_TIMEOUT_S)
            except BaseException:
                open(os.path.join(ref_dir, "failed"), "w").close()
                raise
            nccl["spawn_s"] = time.perf_counter() - t0
            np.savez(os.path.join(ref_dir, "ref.tmp.npz"), **ref)
            os.replace(os.path.join(ref_dir, "ref.tmp.npz"), os.path.join(ref_dir, "ref.npz"))
            log(f"[multi] (a) NCCL world 1: bitwise over {MULTI_PROMPTS} prompts x "
                f"{MULTI_NEW} tokens; launches {nccl['launches']}; collectives "
                f"{nccl['collectives']}; prefix path {nccl['prefix']}; seconds "
                f"{nccl['seconds']:.1f} ({nccl['split']}) of {nccl['spawn_s']:.1f} spawned")
            t1 = time.perf_counter()
            ranks = ranks_f.result()
        returned = time.time()
        t_card = time.perf_counter()
        dryrun = finish_dryrun(dr_proc, dr_out, MULTI_DRYRUN_CELLS)
        card = finish_dryrun(card_proc, card_out, CARD_DRYRUN_CELLS)
        card["after_ranks_s"] = time.perf_counter() - t_card
    finally:
        for proc in (dr_proc, card_proc):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(ref_dir, ignore_errors=True)
    log(f"[multi] dry-run on the host CPU (torch {dryrun['torch']}): "
        f"{[(c['cell'], c['seconds'], c['dominant']) for c in dryrun['cells']]}")
    check_card_dryrun(card)
    cells = [(c["cell"], round(c["peak_bytes"] / 2**30, 3), round(c["temp_bytes"] / 2**30, 3),
              c["launches"]) for c in card["cells"]]
    log(f"[multi] (c) dry-run memory on the card ({card['cells'][0]['measured_on']}): "
        f"(cell, peak GiB, temp GiB, launches) {cells}; {card['after_ranks_s']:.1f}s after the "
        f"ranks")
    dryrun["card"] = card
    bad = {(r, name): rec for r, out in enumerate(ranks)
           for name, rec in out["checks"].items() if not rec.get("ok")}
    if bad:
        raise AssertionError(f"multi(b): checks failed {bad}; errors "
                             f"{[out['errors'] for out in ranks]}")
    tp = ranks[0]["checks"]["tp_serve"]
    tpp = ranks[0]["checks"]["tp_prefix"]
    gloo = {"backend": ranks[0]["backend"], "world": 4, "ranks": ranks,
            "start_s": max(r["t_start"] for r in ranks) - spawned,
            "ref_wait_s": max(r["ref_wait_s"] for r in ranks),
            "exit_s": returned - max(r["t_end"] for r in ranks),
            "seconds": time.perf_counter() - t1}
    log(f"[multi] (b) tp_prefix: |dlogit| {ranks[0]['errors']['tp_prefix']:.4g} of the largest; "
        f"launches a rank {tpp['launches']}; paged {tpp['paged_launches']} bitwise; pool bytes "
        f"a rank {tpp['pool_bytes']} ({tpp['pool_share']} of the whole)")
    log(f"[multi] (b) 4 gloo ranks on one card: errors {ranks[0]['errors']}; tp tokens "
        f"matching {tp['tokens_matching']}/{tp['tokens']}; launches a rank {tp['launches']}; "
        f"ep dropped at 1.25 {ranks[0]['checks']['ep']['dropped_cf1.25']} of "
        f"{ranks[0]['checks']['ep']['pairs']} pairs; staged bytes "
        f"{sum(v['staged_bytes'] for v in ranks[0]['collectives'].values())}; seconds "
        f"{ranks[0]['seconds']}, rank 0's split {ranks[0]['split']}; ranks started "
        f"{gloo['start_s']:.1f}s after the spawn, waited {gloo['ref_wait_s']:.1f}s for (a)'s "
        f"references, and returned {gloo['exit_s']:.1f}s after their last ended")
    return {"nccl": nccl, "gloo": gloo, "dryrun": dryrun,
            "tol": {"tp": MULTI_TP_TOL, "ep": MULTI_EP_TOL, "train": MULTI_TRAIN_TOL},
            "seconds": time.perf_counter() - t0}


def _start_example(name, *argv):
    """``python -m repro_torch.examples.<name>`` in a process of its own (on
    the card: no ``--device`` given)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, "-m", f"repro_torch.examples.{name}", *argv],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish_example(name, proc):
    """(stdout's lines, stderr) of ``_start_example``'s process."""
    stdout, stderr = proc.communicate(timeout=MULTI_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"examples: {name} exited {proc.returncode}: {stderr[-3000:]}")
    return stdout.splitlines(), stderr


def check_example_lines(name, got, want):
    """``got`` equal to ``want`` line by line."""
    if list(got) != list(want):
        raise AssertionError(f"examples: {name} printed\n" + "\n".join(got)
                             + "\nexpected\n" + "\n".join(want))


def check_quickstart(got, stderr):
    """quickstart's lines ``got`` equal to QUICKSTART_LINES but for each
    row's latency, and its ``latency split:`` line (stderr): each method's
    simulated part within QUICKSTART_SIMULATED_TOL of its pin, and the row's
    printed latency (one decimal) the simulated part plus the lookups'
    measured time. Returns the split."""
    split = [json.loads(x.split(": ", 1)[1]) for x in stderr.splitlines()
             if x.startswith("latency split: ")]
    ok = (len(split) == 1 and set(split[0]) == set(QUICKSTART_SIMULATED_S)
          and len(got) == len(QUICKSTART_LINES))
    for g, w in (zip(got, QUICKSTART_LINES) if ok else ()):
        gs, ws = g.split(), w.split()
        if len(ws) != 5 or ws[0] not in QUICKSTART_SIMULATED_S:
            ok &= g == w
            continue
        part = split[0][ws[0]]
        ok &= (gs[:3] + gs[4:] == ws[:3] + ws[4:]
               and abs(part["simulated_s"] - QUICKSTART_SIMULATED_S[ws[0]])
               <= QUICKSTART_SIMULATED_TOL
               and abs(float(gs[3]) - part["simulated_s"] - part["lookup_s"])
               <= 0.05 + QUICKSTART_SIMULATED_TOL)
    if not ok:
        raise AssertionError("examples: quickstart printed\n" + "\n".join(got) + "\n"
                             + stderr[-2000:] + "\nexpected\n" + "\n".join(QUICKSTART_LINES)
                             + f"\nsimulated latency {QUICKSTART_SIMULATED_S}")
    return split[0]


def examples_on_card(torch):
    """Phase 12: the example drivers' twins through their entry points, on
    the card. quickstart, distributed_cache_demo and train_small run as
    processes of their own beside serve_agent, which runs here at published
    widths with the kernels' launch counters set to 0 just before it and
    read just after. Returns the ``{"examples": ...}`` line's body."""
    import contextlib
    import io
    import re

    from repro_torch.examples import serve_agent

    t0 = time.perf_counter()
    procs = {"quickstart": _start_example("quickstart"),
             "distributed_cache_demo": _start_example("distributed_cache_demo"),
             "train_small": _start_example("train_small", "--steps", str(EXAMPLE_TRAIN_STEPS))}
    try:
        kernels = kernel_table.reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_agent.main(["--full", "--n", str(EXAMPLE_SERVE_N)])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
        serve_s = time.perf_counter() - t0
        served = buf.getvalue().splitlines()
        outs = {name: _finish_example(name, proc) for name, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = re.search(r"wall=([0-9.]+)s", served[-2])
    check_example_lines("serve_agent", [re.sub(r"  wall=[0-9.]+s$", "", x) for x in served[1:]],
                        SERVE_AGENT_LINES)
    if not (launches["flash_attention"] and launches["decode_attention"]):
        raise AssertionError(f"examples: serve_agent launched {launches}")
    split = check_quickstart(*outs["quickstart"])
    check_example_lines("distributed_cache_demo", outs["distributed_cache_demo"][0],
                        DCACHE_DEMO_LINES)
    train = outs["train_small"][0]
    steps = EXAMPLE_TRAIN_STEPS
    if (train[0] != "training qwen2.5-3b-smoke: 0.4M params"
            or train[-2] != f"completed {steps} steps; injected faults handled: "
                            f"[({steps // 2}, 'nan')]"
            or not train[-1].endswith("(OK: decreased)")):
        raise AssertionError("examples: train_small printed\n" + "\n".join(train))
    log(f"[examples] serve_agent --full --n {EXAMPLE_SERVE_N}: {served[1:]}, launches "
        f"{launches}; train_small: {train[-2:]}; quickstart and distributed_cache_demo as "
        f"the reference's, quickstart's measured lookup s in its latency "
        f"{ {m: round(v['lookup_s'], 4) for m, v in split.items()} }")
    return {"serve_agent": {"lines": served, "launches": launches, "wall_s": float(wall[1]),
                            "seconds": serve_s},
            "train_small": train, "quickstart": outs["quickstart"][0],
            "quickstart_latency_split": split,
            "distributed_cache_demo": outs["distributed_cache_demo"][0],
            "seconds": time.perf_counter() - t0}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    phase_s = {}
    mark = {"t": t_start}

    def done(name):
        now = time.perf_counter()
        phase_s[name] = now - mark["t"]
        mark["t"] = now
        log(f"[phase] {name}: {phase_s[name]:.1f}s")

    # phase 1: the card
    smi = nvidia_smi()
    log(f"[card] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[card] TF32 off for matmuls and cuDNN")
    done("1_card")

    # phase 2: the build
    t0 = time.perf_counter()
    names = list(kernel_table.KERNELS)
    _build.build(names)
    log(f"[build] {names} built in {time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR}")
    for n, text in _build.build_logs.items():
        log(f"[build] {n}: {ptxas_summary(text)}")
    done("2_build")

    # phase 3: kernels against their plain versions, then timings
    parts = {}

    def part(name, fn):
        t = time.perf_counter()
        res = fn(torch)
        parts[name] = time.perf_counter() - t
        return res

    err, checks = part("check_kernels", check_kernels)
    err["topk_cosine"], checks["topk_cosine"] = part("check_topk", check_topk)
    err["paged_decode_attention"], checks["paged_decode_attention"] = part("check_paged",
                                                                           check_paged)
    scan_err, scan_checks = part("check_scans", check_scans)
    err.update(scan_err)
    checks.update(scan_checks)
    err["ssd_step"], checks["ssd_step"] = part("check_ssd_step", check_ssd_step)
    err["causal_conv"], checks["causal_conv"] = part("check_causal_conv", check_causal_conv)
    timing = [row for name, fn in (("time_kernels", time_kernels), ("time_topk", time_topk),
                                   ("time_paged", time_paged), ("time_scans", time_scans))
              for row in part(name, fn)]
    log(f"[kernels] seconds by part {json.dumps(parts)}")
    done("3_kernels")

    # phase 4: the model on the card against the CPU
    check_model(torch)
    done("4_model")

    # phase 5: serving, one run per path on the same engines
    engines, init_s = build_deployment(torch)
    runs = {row[0]: serve(torch, engines, *row) for row in SERVE_RUNS}
    runs["prefix"] = serve_prefix(torch, engines)
    check_outputs(torch, engines)
    rec_engines, rec_init_s, rec_params = build_recurrent(torch, engines)
    with ChunkDecayProbe(torch) as probe:
        runs["recurrent"] = serve(torch, rec_engines, "recurrent", "financebench", N_TASKS,
                                  PlanAct({"method": "apc"}), RECURRENT_EXPECT,
                                  RECURRENT_KERNELS)
    runs["recurrent"].update(init_s=rec_init_s, params=rec_params,
                             max_chunk_abs_la=probe.result())
    check_shared_block(rec_engines["actor"].cfg, runs["recurrent"]["launches_by_hd"])
    check_step_launches(rec_engines["actor"].cfg, runs["recurrent"]["launches"])
    log(f"[recurrent] largest |la| of a chunk of {MODEL_CHUNK}: {probe.result()}")
    check_outputs(torch, rec_engines)
    del rec_engines  # phase 8 needs their memory
    free_memory(torch)
    done("5_serve")

    # phase 6: the paper's baselines, its other workloads and the
    # deep-research agent, on the DEFAULT engines
    for row in BASELINE_RUNS:
        runs[row[0]] = serve(torch, engines, *row)
    baselines = compare_baselines(runs)
    done("6_baselines")

    # phase 7: the rest of the plan store on the DEFAULT engines: the
    # speculative method, then the traced router over the distributed cache
    for row in SPEC_RUNS:
        runs[row[0]] = serve(torch, engines, *row)
    obs = serve_dcache(torch, engines)
    peak = {"phases_5_7_gib": torch.cuda.max_memory_allocated() / 2**30}
    done("7_plan_store")

    # phase 8: the other families. (a) the families run on the moe, qk-norm
    # and vlm archs beside the nemotron engine; (b) their prefix path; (c)
    # the FLAGSHIP deployment, kimi-k2 at one layer, once nemotron and the
    # families' engines are freed; (d) whisper-tiny's encoder-decoder
    torch.cuda.reset_peak_memory_stats()
    fam, fam_init_s, fam_params = build_families(torch, engines)
    runs["families"] = serve(torch, fam, "families", PHASE8_ENV, PHASE8_TASKS,
                             PlanAct({"method": "apc"}), PHASE8_EXPECT["families"], ATTN)
    check_served("families", runs["families"], FAMILIES_ROLES)
    check_outputs(torch, fam)
    prefix_families = serve_prefix_families(torch, fam)
    runs["families"].update(init_s=fam_init_s, params=fam_params)
    peak["families_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[families] peak memory {peak['families_gib']:.2f} GiB")
    del fam
    engines.pop("large_planner")  # nemotron: no later phase runs it
    free_memory(torch)
    log(f"[flagship] nemotron and the families' engines freed: allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    flag, flag_init_s, flag_params = build_flagship(torch, engines)
    runs["flagship"] = serve(torch, flag, "flagship", PHASE8_ENV, PHASE8_TASKS,
                             PlanAct({"method": "apc"}), PHASE8_EXPECT["flagship"], ATTN)
    check_served("flagship", runs["flagship"], ("large_planner",))
    check_outputs(torch, flag)
    runs["flagship"].update(init_s=flag_init_s, params=flag_params, depth=FLAGSHIP_DEPTH)
    peak["flagship_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[flagship] peak memory {peak['flagship_gib']:.2f} GiB")
    del flag
    free_memory(torch)
    whisper = check_whisper(torch)
    done("8_families")

    # phase 9: the trainer (a) olmo-1b at published width through the
    # fault-tolerant runner with its checkpoints, (b) one step card vs CPU,
    # (c) the trained weights served, (d) the plan cache's cold tier
    engines.clear()  # no later phase serves the DEFAULT engines
    free_memory(torch)
    import shutil
    import tempfile

    scratch = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        train_cfg, trained, train = train_full(torch, os.path.join(scratch, "ckpt"))
        free_memory(torch)
        train["card_vs_cpu"] = train_grad_check(torch)
        train["served"] = serve_trained(torch, train_cfg, trained)
        del trained
        free_memory(torch)
        train["cold"] = cold_on_card(torch, os.path.join(scratch, "cold"))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    done("9_train")
    train["phase_s"] = phase_s["9_train"]

    # phase 10: the deterministic simulation, its fuzzy cells' indexes and
    # oracle twins on the card
    sim = sim_on_card(torch)
    done("10_sim")
    sim["phase_s"] = phase_s["10_sim"]

    # phase 11: the multi-device layer, one NCCL rank, then four gloo ranks
    # sharing the card
    free_memory(torch)
    multi = multi_on_card(torch)
    done("11_multi")
    multi["phase_s"] = phase_s["11_multi"]

    # phase 12: the example drivers' twins, through their entry points
    free_memory(torch)
    examples = examples_on_card(torch)
    free_memory(torch)
    done("12_examples")
    srv = {"init_s": init_s, "serve_depths": SERVE_DEPTHS,
           "max_memory_allocated_gib": max(peak.values()),
           "peak_memory_gib": peak, "prefix_families": prefix_families,
           "whisper": whisper, "runs": runs}

    # per kernel: the representative shape of its path (the attention
    # kernels: nemotron's layout; top-k: the agent's 8 padded queries against
    # the 64-row arena, k = 1; the scans: the served prefill at rwkv6-3b's
    # and zamba2's layouts), and its launches in its path's run
    sources = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:102", "nemotron-4-15b", "exact"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:95", "nemotron-4-15b",
                             "exact"),
        "paged_decode_attention": ("src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                                   "src/repro/kernels/paged_attention.py:123",
                                   "nemotron-4-15b", "prefix"),
        "topk_cosine": ("src/repro_torch/kernels/csrc/topk_cosine.cu",
                        "src/repro/kernels/similarity.py:101", "index", "fuzzy"),
        "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu", "src/repro/kernels/rwkv6.py:94",
                 "rwkv6-3b", "recurrent"),
        "ssd": ("src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:91",
                "zamba2-2.7b", "recurrent"),
        "ssd_step": ("src/repro_torch/kernels/csrc/ssd_step.cu",
                     "none: plain jnp, src/repro/models/mamba.py:130", "nemotron-h-47b",
                     "recurrent"),
        "causal_conv": ("src/repro_torch/kernels/csrc/causal_conv.cu",
                        "none: plain jnp, src/repro/models/mamba.py:52", "nemotron-h-47b",
                        "recurrent"),
    }
    kernels = []
    for name, (src, replaces, arch, run) in sources.items():
        row = next(r for r in timing if r["kernel"] == name and r["arch"] == arch
                   and not r.get("off_path"))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": runs[run]["launches"][name], "max_abs_err": err[name],
            "checks": checks[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "path_run": run,
            "launches_per_task": {r: v["launches_per_task"][name] for r, v in runs.items()
                                  if v.get("launches_per_task", {}).get(name)},
            **({"library": row["library"]} if "library" in row else {}),
            **({"sim_launches": sim["topk_launches"]} if name == "topk_cosine" else {}),
            **({"multi_launches": {
                "nccl_world1": multi["nccl"]["launches"][name],
                "nccl_world1_prefix": multi["nccl"]["prefix"]["launches"][name],
                "gloo_rank_tp4": multi["gloo"]["ranks"][0]["checks"]["tp_serve"]["launches"][
                    name],
                "gloo_rank_tp4_prefix": multi["gloo"]["ranks"][0]["checks"]["tp_prefix"][
                    "launches"][name]}} if name in ("flash_attention", "decode_attention")
               else {}),
            **({"multi_launches": {
                "gloo_rank_tp4_pool": multi["gloo"]["ranks"][0]["checks"]["tp_prefix"][
                    "paged_launches"]}} if name == "paged_decode_attention" else {}),
            "dryrun_card_launches": {"-".join(c["cell"]): c["launches"][name]
                                     for c in multi["dryrun"]["card"]["cells"]},
            "example_launches": examples["serve_agent"]["launches"][name],
        })
    log(f"[serve] engines {init_s:.1f}s, peak memory "
        f"{srv['max_memory_allocated_gib']:.2f} GiB ({peak})")
    total_s = time.perf_counter() - t_start
    log(f"[phases] {json.dumps(phase_s)}")
    log(f"[total] {total_s:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"serve": srv}))
    print(json.dumps({"baselines": baselines}))
    print(json.dumps({"obs": obs}))
    print(json.dumps({"train": train}))
    print(json.dumps({"sim": sim}))
    print(json.dumps({"multi": multi}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"phases": phase_s, "total_s": total_s}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
