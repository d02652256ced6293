"""The comparison that decides ``correct``.

Once the window has closed, a sample of the calls it finished (drawn from
the seed, the longest prompt among them) is run through the plain
reference once, each prompt followed by its served tokens. At the
position each served token was sampled from, the reference's best logit
minus the reference's logit of the served token is that token's gap: 0
where the program chose the reference's best token, and small where
rounding in bf16 flipped a near tie. The number compared is the widest gap
over the sample, against the cell's limit.

The control puts the same reference, in fp8, in the program's place: at
each of those positions the token it ranks first is read off, and its gap
in the float32 reference is taken the same way (``widest_gaps(control=True)``).
"""

from __future__ import annotations

import importlib

import torch


def reference_module(conf: dict):
    """The plain reference the configuration names (``references/<name>.py``),
    which also gives the family's layout, counts and port fields. Refuses a
    configuration of a family the module does not model."""
    mod = importlib.import_module(f"perfbench.references.{conf['reference']}")
    if conf["model_type"] not in mod.MODEL_TYPES:
        raise ValueError(f"references/{conf['reference']}.py models {mod.MODEL_TYPES}, "
                         f"not model_type {conf['model_type']!r}")
    return mod


def checks(limits: dict, failed_calls: int, gap: float) -> dict:
    """The numbers compared, each beside its limit, in the order printed."""
    return {"failed_calls": {"value": failed_calls, "limit": 0},
            "max_logit_gap": {"value": gap, "limit": limits["max_logit_gap"]}}


def verdict(checked: dict) -> bool:
    """``correct``: every number within its limit."""
    return all(c["limit"] is not None and c["value"] <= c["limit"] for c in checked.values())


def _inputs(calls, device):
    """Per call (prompt ids, served ids): the reference's input sequence (the
    prompt and every served token but the last) and the positions each
    served token was sampled from."""
    seqs, positions = [], []
    for prompt, served in calls:
        s = len(prompt)
        seq = torch.cat([torch.as_tensor(prompt, dtype=torch.int64),
                         torch.as_tensor(served[:-1], dtype=torch.int64)])
        seqs.append(seq.to(device))
        positions.append(list(range(s - 1, s - 1 + len(served))))
    return seqs, positions


def _gaps(ref_logits, tokens):
    """Per position: best reference logit minus the reference logit of
    ``tokens`` there."""
    return ref_logits.max(dim=-1).values - ref_logits.gather(-1, tokens[:, None])[:, 0]


def widest_gaps(conf: dict, params: dict, calls, device, *, control: bool = False) -> dict:
    """The widest gap of the served tokens of ``calls`` [(prompt, served)]
    (``served``); with ``control``, also that of the tokens the fp8
    control ranks first at the same positions (``control``)."""
    ref = reference_module(conf)
    seqs, positions = _inputs(calls, device)
    exact = ref.logits(conf, params, seqs, positions)
    served = [torch.as_tensor(s, dtype=torch.int64, device=e.device)
              for e, (_, s) in zip(exact, calls)]
    out = {"served": max(float(_gaps(e, t).max()) for e, t in zip(exact, served))}
    if control:
        low = ref.logits(conf, params, seqs, positions, precision="fp8")
        out["control"] = max(float(_gaps(e, lo.argmax(dim=-1)).max())
                             for e, lo in zip(exact, low))
    return out
