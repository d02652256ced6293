"""Weights made from the seed, on the device, in the parameter layout the
port's ``Engine`` takes (and the reference reads).

The layout is the family's (``layout(conf)`` of the module the
configuration names under ``reference``). Every ``"normal"`` parameter is
a view of one buffer in the served dtype, filled by a single draw of
``init_std * N(0, 1)`` on the device; a constant (norm scales 1, biases 0)
is float32, as the port keeps them. Each view starts at a multiple of 8
elements, so its data pointer is 16-byte aligned as the kernels ask.
"""

from __future__ import annotations

import math

import torch

from perfbench import judge


def _put(tree, path, value):
    """Set ``tree[path[0]][path[1]]...`` to ``value``, making the dicts
    (string keys) and lists (int keys) on the way."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append(None)
        child = node[key] if isinstance(key, int) else node.get(key)
        if child is None:
            child = [] if isinstance(nxt, int) else {}
            node[key] = child
        node = child
    if isinstance(path[-1], int):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def make(conf: dict, seed: int, device) -> dict:
    """The parameter tree of configuration ``conf`` from ``seed``."""
    entries = judge.reference_module(conf).layout(conf)
    drawn = [(path, shape) for path, shape, init in entries if init == "normal"]
    sizes = [-(-math.prod(shape) // 8) * 8 for _, shape in drawn]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), dtype=getattr(torch, conf["dtype"]), device=device)
    flat.normal_(0.0, conf["init_std"], generator=gen)
    params: dict = {}
    off = 0
    for (path, shape), n in zip(drawn, sizes):
        _put(params, path, flat[off:off + math.prod(shape)].view(shape))
        off += n
    for path, shape, init in entries:
        if init != "normal":
            _put(params, path, torch.full(shape, float(init), dtype=torch.float32,
                                          device=device))
    return params
