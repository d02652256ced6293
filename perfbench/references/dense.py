"""Plain reference of a dense decoder-only transformer, in float32.

Follows the configuration file alone (pre-norm blocks: norm, causal
grouped-query attention with split-half RoPE, residual, norm, MLP,
residual; a final norm and the head, tied to the embedding or not). It
imports nothing of the program: it reads the benchmark's weights, upcast
one layer at a time, and runs every matrix product in float32 with TF32
off, so a 15B model's float32 weights never sit on the card at once.

``precision="fp8"`` is the control: every linear layer's input is rounded
to float8 e4m3 with a scale a row, and its weight with a scale an output
column, before the float32 product, as an fp8 GEMM path would compute it.

This module is also what the harness knows of the family, found by the
name a configuration file gives under ``reference``: the configuration
keys held to the port (``PORT_FIELDS``), the parameter layout the weights
are drawn in (``layout``), the attention shapes the kernels' rooflines
count (``attention_shapes``) and the model FLOPs of a call (``call_flops``). A
family with another layout or another FLOP count brings a module of its
own; the harness, ``weights.py`` and ``counts.py`` stay as they are.
"""

from __future__ import annotations

import math

import torch

from perfbench import counts

FP8_MAX = 448.0  # largest finite float8 e4m3fn

# the port's ``ModelConfig.family`` values this module models
MODEL_TYPES = ("dense",)

# configuration file key -> the port's ModelConfig field, compared whole
PORT_FIELDS = {
    "num_hidden_layers": "num_layers", "hidden_size": "d_model",
    "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
    "hidden_act": "mlp_act", "norm": "norm_type", "tie_word_embeddings": "tie_embeddings",
    "rope_theta": "rope_theta", "dtype": "dtype", "model_type": "family",
}


def _norm_leaves(conf: dict, name: str) -> list:
    """(key, init) of a norm's parameters: scale 1 and bias 0, as the port
    keeps them; a non-parametric LayerNorm has none."""
    kind = conf["norm"]
    if kind == "layernorm_np":
        return []
    if kind == "rmsnorm":
        return [(f"{name}_scale", 1.0)]
    if kind == "layernorm":
        return [(f"{name}_scale", 1.0), (f"{name}_bias", 0.0)]
    raise ValueError(f"norm {kind!r}")


def layout(conf: dict) -> list:
    """(path, shape, init) of every parameter, in draw order. ``init`` is
    ``"normal"`` for a matrix (``init_std`` · N(0, 1) in the served dtype,
    used as ``x @ W``) or a constant (float32). A path's strings are dict
    keys and its ints list indices, as the port's ``Engine`` takes them."""
    d, q = conf["hidden_size"], conf["num_attention_heads"] * conf["head_dim"]
    kv, ff = conf["num_key_value_heads"] * conf["head_dim"], conf["intermediate_size"]
    out = [(("embed",), (conf["vocab_size"], d), "normal")]
    if not conf["tie_word_embeddings"]:
        out.append((("head",), (d, conf["vocab_size"]), "normal"))
    mlp = ([("w_gate", (d, ff))] if conf["hidden_act"] == "swiglu" else []) + \
        [("w_up", (d, ff)), ("w_down", (ff, d))]
    for i in range(conf["num_hidden_layers"]):
        b = ("blocks", i)
        out += [(b + ("attn", n), shape, "normal") for n, shape in
                (("wq", (d, q)), ("wk", (d, kv)), ("wv", (d, kv)), ("wo", (q, d)))]
        out += [(b + ("mlp", n), shape, "normal") for n, shape in mlp]
    norms = [((k,), (d,), v) for k, v in _norm_leaves(conf, "final")]
    for i in range(conf["num_hidden_layers"]):
        norms += [(("blocks", i, k), (d,), v)
                  for name in ("ln1", "ln2") for k, v in _norm_leaves(conf, name)]
    return out + norms


def attention_shapes(conf: dict) -> counts.Attn:
    """Every layer runs causal attention: flash in prefill, the decode
    kernel in each decode step."""
    return counts.Attn(layers=conf["num_hidden_layers"], heads=conf["num_attention_heads"],
                       kv_heads=conf["num_key_value_heads"], head_dim=conf["head_dim"])


def call_flops(conf: dict, prompt_len: int, max_new: int) -> float:
    """The operations one call needs: a prefill of ``prompt_len`` tokens,
    then ``max_new - 1`` decode steps, the head at the ``max_new``
    positions sampled from, and the causal half of attention."""
    d, L = conf["hidden_size"], conf["num_hidden_layers"]
    tokens = prompt_len + max_new - 1
    per_token = sum(math.prod(shape) for path, shape, init in layout(conf)
                    if init == "normal" and path[0] == "blocks" and path[1] == 0)
    linear = 2.0 * per_token * L * tokens
    pairs = counts.causal_pairs(prompt_len) + counts.decode_pairs(prompt_len, max_new - 1)
    attn = counts.attention_flops(attention_shapes(conf), pairs) * L
    head = counts.matmul_flops(max_new, d, conf["vocab_size"])
    return linear + attn + head


def _quant_fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``,
    returned in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Linear:
    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32 or fp8")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        return _quant_fp8(w, 0) if self.fp8 else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., in) float32 by an already prepared weight (in, out)."""
        if self.fp8:
            x = _quant_fp8(x, -1)
        return x @ w


def norm(conf: dict, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    eps = conf["norm_eps"]
    kind = conf["norm"]
    if kind == "rmsnorm":
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * p[f"{name}_scale"].float()
    mu = x.mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt((x - mu).square().mean(-1, keepdim=True) + eps)
    if kind == "layernorm":
        x = x * p[f"{name}_scale"].float() + p[f"{name}_bias"].float()
    elif kind != "layernorm_np":
        raise ValueError(f"norm {kind!r}")
    return x


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd): split-half rotary embedding at positions 0..S-1."""
    S, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(conf: dict, q, k, v) -> torch.Tensor:
    """Causal softmax attention, scores materialised: q (S, Hq, hd), k/v
    (S, Hkv, hd) -> (S, Hq * hd)."""
    S, Hq, hd = q.shape
    g = Hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v).reshape(S, -1)


def mlp(conf: dict, lin: Linear, w: dict, x: torch.Tensor) -> torch.Tensor:
    if conf["hidden_act"] == "swiglu":
        h = torch.nn.functional.silu(lin(x, w["w_gate"])) * lin(x, w["w_up"])
    elif conf["hidden_act"] == "squared_relu":
        h = torch.relu(lin(x, w["w_up"])).square()
    else:
        raise ValueError(f"hidden_act {conf['hidden_act']!r}")
    return lin(h, w["w_down"])


def layer(conf: dict, lin: Linear, p: dict, w: dict, x: torch.Tensor) -> torch.Tensor:
    """One block over one sequence x (S, D)."""
    S = x.shape[0]
    hd, H, Hkv = conf["head_dim"], conf["num_attention_heads"], conf["num_key_value_heads"]
    h = norm(conf, p, "ln1", x)
    q = rope(lin(h, w["wq"]).reshape(S, H, hd), conf["rope_theta"])
    k = rope(lin(h, w["wk"]).reshape(S, Hkv, hd), conf["rope_theta"])
    v = lin(h, w["wv"]).reshape(S, Hkv, hd)
    x = x + lin(attention(conf, q, k, v), w["wo"])
    return x + mlp(conf, lin, w, norm(conf, p, "ln2", x))


@torch.no_grad()
def logits(conf: dict, params: dict, seqs, positions, *, precision: str = "fp32"):
    """Float32 logits of each sequence in ``seqs`` (1-D int tensors on the
    weights' device) at its ``positions`` (lists of indices): a list of
    (len(positions[i]), vocab) tensors. Runs layer by layer over all the
    sequences, each layer's weights upcast once."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        lin = Linear(precision)
        xs = [params["embed"][s.long()].to(torch.float32) for s in seqs]
        for blk in params["blocks"]:
            w = {n: lin.weight(t) for part in ("attn", "mlp") for n, t in blk[part].items()}
            xs = [layer(conf, lin, blk, w, x) for x in xs]
            del w
        head = params["embed"].T if conf["tie_word_embeddings"] else params["head"]
        head = lin.weight(head)
        return [lin(norm(conf, params, "final", x[list(pos)]), head)
                for x, pos in zip(xs, positions)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
