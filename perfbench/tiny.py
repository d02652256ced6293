"""Tiny copies of the benchmark's cells for the CPU tests: the cell's
configuration at small widths and a few layers, its traffic cut to a few
short calls, and the port's ``ModelConfig`` made to match."""

from __future__ import annotations

import dataclasses

from perfbench import harness, judge

# the limit of the output check at these sizes, set as the cells' are: from
# the bf16 program's readings and the fp8 control's (test_perfbench_control)
TINY_LIMIT = 0.025


def cell(name: str, *, limit: float = TINY_LIMIT, **traffic):
    """(Cell, ModelConfig) of cell ``name`` at a size the CPU runs in
    seconds; ``traffic`` overrides the cut traffic's parameters."""
    full = harness.load_cell(name)
    gqa = full.conf["num_key_value_heads"] < full.conf["num_attention_heads"]
    conf = dict(full.conf, num_hidden_layers=2, hidden_size=256, num_attention_heads=4,
                num_key_value_heads=2 if gqa else 4, head_dim=64, intermediate_size=512,
                vocab_size=4096)
    from repro_torch.configs import registry

    fields = judge.reference_module(conf).PORT_FIELDS
    cfg = dataclasses.replace(registry.get(conf["arch"]),
                              **{f: conf[k] for k, f in fields.items()})
    tr = dict(full.traffic, concurrency=4, prefix_tokens=min(full.traffic["prefix_tokens"], 40),
              suffix_tokens=[5, 12], max_new=16, check_rows=16)
    tr.update(traffic)
    return dataclasses.replace(full, conf=conf, traffic=tr,
                               limits={"max_logit_gap": limit}), cfg
