"""The other four paper workloads: TabMWP, QASPER, AIME, GAIA (the twin of
``repro.envs.workloads``), the env registry of all five, and the seeded
traffic of the deterministic simulation (``sim_traffic``).

Each differs along the axes that matter to APC:
  * TabMWP  — short tabular contexts, ~30 recurring intents (high hit rate).
  * QASPER  — paper-QA, medium contexts, ~35 intents.
  * AIME    — competition math, few tasks, multi-round, moderate reuse.
  * GAIA    — heterogeneous open-domain tasks: most intents are unique
    (keyword rarely recurs), reproducing the paper's finding that initial
    planning rarely hits but re-planning still benefits.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List

from repro_torch.envs.base import AgentEnv, IntentSpec
from repro_torch.envs.finance import FinanceEnv


def _mk(prefix, kw, tmpl, rounds, expr, para=()):
    return IntentSpec(
        id=f"{prefix}-{kw.replace(' ', '-')}",
        keyword=kw,
        query_template=tmpl,
        rounds=rounds,
        expr=expr,
        paraphrase_keywords=tuple(para),
    )


class TabMWPEnv(AgentEnv):
    name = "tabmwp"
    context_tokens_range = (300, 900)

    def intents(self) -> List[IntentSpec]:
        specs = [
            ("mean calculation", [["col_sum", "col_count"]], "a / b"),
            ("column total", [["col_sum"]], "a"),
            ("difference of entries", [["entry_x", "entry_y"]], "a - b"),
            ("max minus min", [["col_max", "col_min"]], "a - b"),
            ("unit price", [["total_price", "quantity"]], "a / b"),
            ("total cost", [["unit_price", "quantity"]], "a * b"),
            ("change in stock", [["stock_end", "stock_start"]], "a - b"),
            ("rate per hour", [["distance", "hours"]], "a / b"),
            ("median proxy", [["mid_low", "mid_high"]], "(a + b) / 2"),
            ("range of column", [["col_max", "col_min"]], "a - b"),
            ("percent of total", [["part_value", "col_sum"]], "a / b * 100"),
            ("remaining budget", [["budget", "spent"]], "a - b"),
            ("items affordable", [["budget", "unit_price"]], "a / b"),
            ("combined weight", [["weight_x", "weight_y"]], "a + b"),
            ("average of two rows", [["row_x_sum", "row_y_sum"]], "(a + b) / 2"),
            ("tax amount", [["subtotal", "tax_rate"]], "a * b / 100"),
            ("tip total", [["bill", "tip_rate"]], "a * (1 + b / 100)"),
            ("profit from sales", [["revenue_v", "cost_v"]], "a - b"),
            ("ratio of columns", [["col_a_sum", "col_b_sum"]], "a / b"),
            ("weekly total", [["daily_avg"]], "a * 7"),
            ("dozen price", [["unit_price"]], "a * 12"),
            ("split evenly", [["total_price", "people"]], "a / b"),
            ("speed difference", [["speed_x", "speed_y"]], "a - b"),
            ("area of table grid", [["rows_n", "cols_n"]], "a * b"),
            ("fraction simplified", [["numer", "denom"]], "a / b"),
            ("discounted price", [["list_price", "discount_pct"]], "a * (1 - b / 100)"),
            ("total pages read", [["pages_per_day", "days_n"]], "a * b"),
            ("savings goal weeks", [["goal_amt", "weekly_save"]], "a / b"),
            (
                "two step budget",
                [["budget", "spent"], ["unit_price"]],
                "(a - b) / c",
            ),
            (
                "table then rate",
                [["col_sum", "col_count"], ["hours"]],
                "(a / b) / c",
            ),
        ]
        return [
            _mk(
                "tab",
                kw,
                "Using the table for {student} from {month}: what is the %s? "
                "Answer with a number." % kw,
                r,
                e,
                (kw + " from table",),
            )
            for kw, r, e in specs
        ]

    def entities(self) -> Dict[str, List[str]]:
        return {
            "student": ["Ava", "Ben", "Caleb", "Dina", "Eli", "Fern", "Gus",
                        "Hana", "Ira", "Jude", "Kira", "Liam", "Mona", "Nico"],
            "month": ["January", "February", "March", "April", "May", "June",
                      "July", "August", "September", "October"],
        }


class QasperEnv(AgentEnv):
    name = "qasper"
    context_tokens_range = (4_000, 8_000)

    def intents(self) -> List[IntentSpec]:
        specs = [
            ("dataset size", [["train_examples"]], "a"),
            ("improvement over baseline", [["model_score", "baseline_score"]], "a - b"),
            ("relative gain", [["model_score", "baseline_score"]], "(a - b) / b"),
            ("parameter count", [["param_millions"]], "a"),
            ("training epochs", [["epochs_n"]], "a"),
            ("f1 average", [["f1_dev", "f1_test"]], "(a + b) / 2"),
            ("ablation drop", [["full_score", "ablated_score"]], "a - b"),
            ("annotation agreement", [["kappa_score"]], "a"),
            ("corpus token count", [["corpus_tokens_m"]], "a"),
            ("layers used", [["layers_n"]], "a"),
            ("learning rate scaled", [["lr_base", "batch_scale"]], "a * b"),
            ("compute budget", [["gpu_hours", "gpu_cost"]], "a * b"),
            ("accuracy delta across langs", [["acc_lang_x", "acc_lang_y"]], "a - b"),
            ("human eval mean", [["human_score_sum", "human_raters"]], "a / b"),
            ("error rate", [["errors_n", "total_examples"]], "a / b"),
            ("speedup factor", [["latency_base", "latency_new"]], "a / b"),
            ("memory saving", [["mem_base", "mem_new"]], "(a - b) / a"),
            ("dev test gap", [["f1_dev", "f1_test"]], "a - b"),
            ("citations per year", [["citations_n", "years_since"]], "a / b"),
            ("vocab coverage", [["covered_tokens", "corpus_tokens_m"]], "a / b"),
            ("throughput", [["examples_n", "seconds_n"]], "a / b"),
            ("pretrain finetune ratio", [["pretrain_steps", "finetune_steps"]], "a / b"),
            ("agreement minus chance", [["raw_agreement", "chance_agreement"]],
             "(a - b) / (1 - b)"),
            ("mean sentence length", [["token_count", "sentence_count"]], "a / b"),
            ("oov rate", [["oov_n", "token_count"]], "a / b"),
            (
                "two section synthesis",
                [["model_score", "baseline_score"], ["param_millions"]],
                "(a - b) / c",
            ),
            (
                "efficiency normalized gain",
                [["model_score", "baseline_score"], ["gpu_hours"]],
                "(a - b) / c",
            ),
        ]
        return [
            _mk(
                "qas",
                kw,
                "From the paper '{paper}' ({venue}): report the %s as a single "
                "number, citing the relevant section." % kw,
                r,
                e,
                (kw + " lookup",),
            )
            for kw, r, e in specs
        ]

    def entities(self) -> Dict[str, List[str]]:
        return {
            "paper": [f"Study-{i:03d}" for i in range(60)],
            "venue": ["ACL", "EMNLP", "NAACL", "ICLR", "NeurIPS", "ICML"],
        }


class AimeEnv(AgentEnv):
    name = "aime"
    context_tokens_range = (100, 300)
    value_range = (2.0, 60.0)

    def intents(self) -> List[IntentSpec]:
        specs = [
            ("remainder computation", [["big_n", "mod_m"]], "a - b * (a // b) if False else a % b"),
            ("triangle area", [["base_len", "height_len"]], "a * b / 2"),
            ("arithmetic series sum", [["first_term", "last_term"], ["terms_n"]],
             "(a + b) * c / 2"),
            ("geometric mean", [["val_x", "val_y"]], "sqrt(a * b)"),
            ("quadratic vertex", [["coef_a", "coef_b"]], "-b / (2 * a)"),
            ("distance formula", [["dx_sq", "dy_sq"]], "sqrt(a + b)"),
            ("combinatorial ratio", [["ways_total", "ways_valid"]], "b / a"),
            ("digit sum proxy", [["num_tens", "num_ones"]], "a + b"),
            ("probability product", [["p_first", "p_second"]], "a * b"),
            ("expected value two outcome", [["p_win", "payoff"], ["loss_amt"]],
             "a * b - (1 - a) * c"),
            ("circle sector area", [["radius_r", "angle_frac"]], "3.14159265 * a * a * b"),
            ("work rate combined", [["rate_x", "rate_y"]], "1 / (1 / a + 1 / b)"),
        ]
        out = []
        for kw, r, e in specs:
            if "%" in e or "//" in e:
                e = "a - b * 3"  # keep DSL arithmetic simple & closed-form
            out.append(
                _mk(
                    "aime",
                    kw,
                    "AIME {year} problem {pnum}: compute the %s given the stated "
                    "quantities. Provide the numeric answer." % kw,
                    r,
                    e,
                    (kw + " problem",),
                )
            )
        return out

    def entities(self) -> Dict[str, List[str]]:
        return {
            "year": ["2024", "2025"],
            "pnum": [str(i) for i in range(1, 16)],
        }


class GaiaEnv(AgentEnv):
    """Open-domain assistant tasks — intent space is nearly unique per task,
    so keyword reuse is rare (paper §4.2 GAIA analysis). Implemented by
    generating a large intent pool relative to typical run sizes."""

    name = "gaia"
    context_tokens_range = (1_500, 5_000)

    _VERBS = ["total", "difference", "ratio", "average", "share"]
    _DOMAINS = [
        "museum visitor logs", "olympic medal tables", "arxiv submission stats",
        "wikipedia edit history", "sales ledgers", "video dialogue transcripts",
        "census snapshots", "github release notes", "weather station records",
        "shipping manifests", "conference schedules", "music chart archives",
        "patent filings", "menu price lists", "train timetables",
        "library catalogs", "football season stats", "satellite pass logs",
        "power grid reports", "vaccine trial tables", "movie box office",
        "crypto order books", "air quality sensors", "court docket summaries",
        "grocery inventories", "marathon splits", "telescope observation logs",
        "podcast episode stats", "startup funding rounds", "energy futures",
    ]

    def intents(self) -> List[IntentSpec]:
        out = []
        i = 0
        for dom in self._DOMAINS:
            for verb in self._VERBS:
                kw = f"{verb} from {dom}"
                expr = {
                    "total": "a + b",
                    "difference": "a - b",
                    "ratio": "a / b",
                    "average": "(a + b) / 2",
                    "share": "a / (a + b)",
                }[verb]
                out.append(
                    _mk(
                        "gaia",
                        kw,
                        "Research task {tag}: using %s, determine the %s of the two "
                        "relevant quantities and answer numerically." % (dom, verb),
                        [["metric_alpha", "metric_beta"]],
                        expr,
                    )
                )
                i += 1
        return out  # 150 intents -> rarely recur within a 165-task run

    def entities(self) -> Dict[str, List[str]]:
        return {"tag": [f"G{i:04d}" for i in range(400)]}


ENVS = {
    "financebench": FinanceEnv,
    "tabmwp": TabMWPEnv,
    "qasper": QasperEnv,
    "aime": AimeEnv,
    "gaia": GaiaEnv,
}


def get_env(name: str) -> AgentEnv:
    return ENVS[name]()


ALL_ENVS = ["financebench", "tabmwp", "qasper", "aime", "gaia"]


# -- seeded traffic of the deterministic simulation (repro_torch.sim) ---------

SIM_SCENARIOS = ("skewed_reuse", "paraphrase_burst", "evict_then_hit", "uniform")


def _zipf_pick(rng: random.Random, n: int, s: float = 1.2) -> int:
    """Zipf-skewed index in [0, n): rank r with weight 1/(r+1)^s."""
    weights = [1.0 / (r + 1) ** s for r in range(n)]
    return rng.choices(range(n), weights=weights, k=1)[0]


def sim_traffic(
    scenario: str,
    seed: int,
    *,
    n_ops: int = 60,
    n_clients: int = 4,
    batch: int = 4,
    env: str = "tabmwp",
) -> List[List[Dict[str, Any]]]:
    """One seeded op stream per logical client for the ``repro_torch.sim`` harness.

    Every op is a plain dict the harness applies against the store under
    test AND its sequential model, so generation must be fully determined
    by ``(scenario, seed, sizes)``:

    * ``{"op": "lookup", "kws": [...]}`` — one ``lookup_batch`` wave;
    * ``{"op": "insert", "kws": [...]}`` — one ``insert_batch`` admission
      wave (the harness assigns versioned payloads);
    * ``{"op": "remove", "kw": ...}`` / ``{"op": "autotune"}`` — sprinkled
      maintenance traffic;
    * ``{"op": "keys"}`` / ``{"op": "len"}`` — control-plane scans
      (``skewed_reuse`` only): they pay one interceptor RPC per shard and
      are checked against the model's reachable-key union, so a crashed or
      churned shard's visibility is oracle-verified too.

    Scenarios:

    * ``skewed_reuse`` — zipf-skewed draws over the env's recurring
      intents: a hot head that re-hits constantly plus a long cold tail.
    * ``paraphrase_burst`` — inserts a canonical keyword, then bursts
      lookups of its paraphrase variants (fuzzy/semantic tier pressure).
    * ``evict_then_hit`` — adversarial floods of one-shot keys that force
      eviction churn, interleaved with immediate lookups of the newest
      wave (catches evict-during-wave and index-desync bugs).
    * ``uniform`` — uniform reference traffic.
    """
    if scenario not in SIM_SCENARIOS:
        raise ValueError(f"unknown sim scenario {scenario!r}; one of {SIM_SCENARIOS}")
    rng = random.Random((seed, scenario).__repr__())
    intents = get_env(env).intents()
    kws = [it.keyword for it in intents]
    paras = {it.keyword: list(it.paraphrase_keywords) for it in intents}

    clients: List[List[Dict[str, Any]]] = [[] for _ in range(n_clients)]
    for ci in range(n_clients):
        ops = clients[ci]
        fresh = 0  # per-client unique-key counter (evict_then_hit floods)
        while len(ops) < n_ops:
            r = rng.random()
            if scenario == "skewed_reuse":
                wave = [kws[_zipf_pick(rng, len(kws))] for _ in range(batch)]
                if r < 0.30:
                    ops.append({"op": "insert", "kws": wave})
                elif r < 0.93:
                    ops.append({"op": "lookup", "kws": wave})
                elif r < 0.955:
                    ops.append({"op": "remove", "kw": wave[0]})
                elif r < 0.97:
                    ops.append({"op": "autotune"})
                elif r < 0.985:
                    ops.append({"op": "keys"})
                else:
                    ops.append({"op": "len"})
            elif scenario == "paraphrase_burst":
                canon = kws[_zipf_pick(rng, len(kws))]
                variants = paras.get(canon) or [canon]
                if r < 0.35:
                    ops.append({"op": "insert", "kws": [canon]})
                else:
                    burst = [rng.choice([canon] + variants) for _ in range(batch)]
                    ops.append({"op": "lookup", "kws": burst})
            elif scenario == "evict_then_hit":
                if r < 0.5:
                    flood = [f"c{ci}-one-shot-{fresh + j}" for j in range(batch)]
                    fresh += batch
                    # re-insert a (likely resident) hot key MID-wave: the
                    # case where evict-during-wave diverges from the
                    # evict-after-wave contract (the hot key can be chosen
                    # as victim before its own re-insert lands, costing an
                    # extra eviction that kills a key the policy says
                    # should survive)
                    hot = kws[_zipf_pick(rng, min(8, len(kws)))]
                    flood.insert(len(flood) // 2, hot)
                    ops.append({"op": "insert", "kws": flood})
                    # adversarial: immediately demand the newest wave back
                    ops.append({"op": "lookup", "kws": list(reversed(flood))})
                else:
                    hot = kws[_zipf_pick(rng, min(8, len(kws)))]
                    ops.append({"op": "insert" if r < 0.6 else "lookup",
                                "kws": [hot]})
            else:  # uniform
                wave = [rng.choice(kws) for _ in range(batch)]
                ops.append({"op": "insert" if r < 0.4 else "lookup", "kws": wave})
        del ops[n_ops:]  # evict_then_hit appends in pairs; trim to size
    return clients


__all__ = ["ALL_ENVS", "ENVS", "SIM_SCENARIOS", "AimeEnv", "GaiaEnv", "QasperEnv", "TabMWPEnv",
           "get_env", "sim_traffic"]
