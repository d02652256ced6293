"""Plain reference of Nemotron-H, a hybrid Mamba-2 / attention decoder, in
float32.

Follows the configuration file alone (the upstream ``NemotronHForCausalLM``
equations): layer i is of the kind ``hybrid_override_pattern[i]`` for the
first ``num_hidden_layers`` characters, each ``x + mixer(RMSNorm(x))`` at
``layer_norm_epsilon``, then a final RMSNorm and the untied head.

* ``M``, Mamba-2: ``in_proj`` (no bias) gives [z, x, B (G·N), C (G·N), dt];
  a depthwise causal conv of ``conv_kernel`` taps with bias over x, B and C,
  then silu; ``dt = softplus(dt + dt_bias)`` (``time_step_limit`` (0, inf):
  no clamp); ``A = -exp(A_log)``; per head h of group g = h // (heads / G)
  the scan ``H_t = exp(dt_t A) H_{t-1} + dt_t x_t B_{g,t}ᵀ``, ``y_t = H_t
  C_{g,t} + D x_t``; then ``y * silu(z)``, an RMSNorm over each group's
  d_inner / G channels (``norm_before_gate=False``) and ``out_proj``. The
  heads are ``expand * hidden_size / mamba_head_dim``.
* ``-``, MLP: ``down(relu(up x)²)``, no biases.
* ``*``, attention: causal grouped-query attention, no biases and no
  position encoding, scale 1/sqrt(head dim).

The scan runs a chunk of ``chunk_size`` steps at a time on differences of
cumulative decays inside the chunk, masked before the exponential, so no
exponential exceeds 1 and nothing overflows; the state carries from chunk
to chunk in float32.

It imports nothing of the program: it reads the benchmark's weights, upcast
one layer at a time, and runs every product in float32 with TF32 off.
``precision="fp8"`` is the control: every linear layer's input is rounded
to float8 e4m3 with a scale a row, and its weight with a scale an output
column, as in ``dense.py``; the scan, the conv and the norms stay float32.

What the harness knows of the family, as ``dense.py`` gives it:
``PORT_FIELDS``, ``layout``, ``attention_shapes``, ``call_flops``, and the
scan's operations and bytes a launch (``ssd_launch``, for
``ssd_scan_roofline``) with the Mamba-2 layers' count (``mamba_layers``).
"""

from __future__ import annotations

import math

import torch

from perfbench import counts
from perfbench.references import dense

MODEL_TYPES = ("nemotron_h",)

# configuration file key -> the port's ModelConfig field, compared whole
# (top-level fields only: the Mamba-2 widths are held to ``cfg.ssm`` by
# perfbench/test_perfbench_nemotron_h.py)
PORT_FIELDS = {
    "num_hidden_layers": "num_layers", "hidden_size": "d_model",
    "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "attention_head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
    "tie_word_embeddings": "tie_embeddings", "hybrid_override_pattern": "hybrid_pattern",
    "layer_norm_epsilon": "norm_eps", "dtype": "dtype", "model_type": "family",
}

MAMBA, MLP, ATTN = "M", "-", "*"


def kinds(conf: dict) -> str:
    """Each layer's kind: the pattern's first ``num_hidden_layers`` characters."""
    k = conf["hybrid_override_pattern"][:conf["num_hidden_layers"]]
    if len(k) != conf["num_hidden_layers"] or set(k) - {MAMBA, MLP, ATTN}:
        raise ValueError(f"hybrid_override_pattern gives no kind to each of "
                         f"{conf['num_hidden_layers']} layers")
    if conf["mlp_hidden_act"] != "relu2" or conf["mamba_hidden_act"] != "silu":
        raise ValueError("the reference models relu2 MLPs and silu Mamba-2 mixers")
    return k


def mamba_dims(conf: dict):
    """(d_inner, heads, head dim, groups, state, conv channels)."""
    d_in = conf["expand"] * conf["hidden_size"]
    P, G, N = conf["mamba_head_dim"], conf["n_groups"], conf["ssm_state_size"]
    return d_in, d_in // P, P, G, N, d_in + 2 * G * N


def mamba_layers(conf: dict) -> int:
    return kinds(conf).count(MAMBA)


def layout(conf: dict) -> list:
    """(path, shape, init) of every parameter, in draw order, as
    ``dense.layout`` gives them: the matrices drawn; the norm scales, the
    conv's taps and bias and the per-head constants held at the file's
    values (float32)."""
    d, V, F = conf["hidden_size"], conf["vocab_size"], conf["intermediate_size"]
    q = conf["num_attention_heads"] * conf["attention_head_dim"]
    kv = conf["num_key_value_heads"] * conf["attention_head_dim"]
    d_in, H, _, _, _, ch = mamba_dims(conf)
    out = [(("embed",), (V, d), "normal")]
    if not conf["tie_word_embeddings"]:
        out.append((("head",), (d, V), "normal"))
    mats = {MAMBA: ("mamba", (("in_proj", (d, d_in + ch + H)), ("out_proj", (d_in, d)))),
            MLP: ("mlp", (("w_up", (d, F)), ("w_down", (F, d)))),
            ATTN: ("attn", (("wq", (d, q)), ("wk", (d, kv)), ("wv", (d, kv)), ("wo", (q, d))))}
    ks = kinds(conf)
    for i, k in enumerate(ks):
        part, shapes = mats[k]
        out += [(("blocks", i, part, n), shape, "normal") for n, shape in shapes]
    out.append((("final_scale",), (d,), 1.0))
    for i, k in enumerate(ks):
        out.append((("blocks", i, "ln1_scale"), (d,), 1.0))
        if k == MAMBA:
            out += [(("blocks", i, "mamba", n), shape, float(v)) for n, shape, v in (
                ("conv_w", (conf["conv_kernel"], ch), conf["mamba_conv_w"]),
                ("conv_b", (ch,), 0.0), ("A_log", (H,), conf["mamba_A_log"]),
                ("dt_bias", (H,), conf["mamba_dt_bias"]), ("D", (H,), conf["mamba_D"]),
                ("norm_scale", (d_in,), 1.0))]
    return out


def attention_shapes(conf: dict):
    """The attention layers' shapes; None where the layers hold none."""
    n = kinds(conf).count(ATTN)
    if not n:
        return None
    return counts.Attn(layers=n, heads=conf["num_attention_heads"],
                       kv_heads=conf["num_key_value_heads"], head_dim=conf["attention_head_dim"])


def scan_flops_per_token(conf: dict) -> float:
    """The scan's least operations a token and Mamba-2 layer: per head,
    the state's decay and update (2 P N) and its product with C (2 P N)."""
    _, H, P, _, N, _ = mamba_dims(conf)
    return 4.0 * H * P * N


def ssd_launch(conf: dict, batch: int, seq: int):
    """(operations, bytes) of one scan launch over ``batch`` rows of
    ``seq`` steps, the least any scan needs: the scan's least operations;
    x, B and C in the served dtype, dt, A_log and D (float32) read once, y
    in the served dtype (the model takes it to that dtype before its norm)
    and the final state (float32) written once."""
    _, H, P, G, N, _ = mamba_dims(conf)
    e = torch.empty((), dtype=getattr(torch, conf["dtype"])).element_size()
    tokens = batch * seq
    read = tokens * (H * P + 2 * G * N) * e + tokens * H * 4 + 2 * H * 4
    written = tokens * H * P * e + batch * H * P * N * 4
    return scan_flops_per_token(conf) * tokens, read + written


def call_flops(conf: dict, prompt_len: int, max_new: int) -> float:
    """The operations one call needs: a prefill of ``prompt_len`` tokens,
    then ``max_new - 1`` decode steps: every layer's matrices, the
    Mamba-2 layers' conv (2 taps·channels) and scan (``scan_flops_per_token``)
    at each token, the causal half of attention, and the head at the
    ``max_new`` positions sampled from."""
    tokens = prompt_len + max_new - 1
    matrices = sum(math.prod(shape) for path, shape, init in layout(conf)
                   if init == "normal" and path[0] == "blocks")
    _, _, _, _, _, ch = mamba_dims(conf)
    mixer = (2.0 * conf["conv_kernel"] * ch + scan_flops_per_token(conf)) * mamba_layers(conf)
    a = attention_shapes(conf)
    attn = 0.0
    if a is not None:
        pairs = counts.causal_pairs(prompt_len) + counts.decode_pairs(prompt_len, max_new - 1)
        attn = counts.attention_flops(a, pairs) * a.layers
    head = counts.matmul_flops(max_new, conf["hidden_size"], conf["vocab_size"])
    return 2.0 * matrices * tokens + mixer * tokens + attn + head


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def scan(x, dt, A, Bg, Cg, D, chunk: int):
    """The Mamba-2 scan of one sequence from a zero state: x (S, H, P), dt
    (S, H), A and D (H,), Bg and Cg (S, G, N) -> y (S, H, P). Within a
    chunk, step i's decay since step j is exp(la_i - la_j) with la the
    cumulative log decay since the chunk's start, taken only for j <= i."""
    S, H, P = x.shape
    G = Bg.shape[1]
    per = H // G
    state = x.new_zeros((H, P, Bg.shape[-1]))
    ys = []
    for c0 in range(0, S, chunk):
        xb, dtb = x[c0:c0 + chunk], dt[c0:c0 + chunk]
        Bb, Cb = Bg[c0:c0 + chunk], Cg[c0:c0 + chunk]
        n = xb.shape[0]
        la = torch.cumsum(dtb * A, dim=0)  # (n, H), <= 0 and falling
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        seg = (la[:, None] - la[None, :]).masked_fill(~causal[..., None], float("-inf"))
        cb = torch.einsum("ign,jgn->ijg", Cb, Bb).repeat_interleave(per, dim=-1)  # (n, n, H)
        dtx = xb * dtb[..., None]  # (n, H, P)
        Ch = Cb.repeat_interleave(per, dim=1)  # (n, H, N)
        Bh = Bb.repeat_interleave(per, dim=1)
        y = torch.einsum("ijh,jhp->ihp", cb * torch.exp(seg), dtx)
        y = y + torch.exp(la)[..., None] * torch.einsum("hpn,ihn->ihp", state, Ch)
        ys.append(y + D[:, None] * xb)
        tail = torch.exp(la[-1:] - la)  # (n, H): decay from step j to the chunk's end
        state = torch.exp(la[-1])[:, None, None] * state + torch.einsum(
            "jhp,jhn->hpn", dtx * tail[..., None], Bh)
    return torch.cat(ys, dim=0)


def mamba(conf: dict, lin, p: dict, w: dict, x: torch.Tensor) -> torch.Tensor:
    """One Mamba-2 mixer over one sequence x (S, D)."""
    d_in, H, P, G, N, ch = mamba_dims(conf)
    S = x.shape[0]
    proj = lin(x, w["in_proj"])
    z, xbc, dt = proj[:, :d_in], proj[:, d_in:d_in + ch], proj[:, d_in + ch:]
    K = conf["conv_kernel"]
    conv_w = p["conv_w"].float()  # (K, ch): tap k reads position t - (K - 1) + k
    padded = torch.cat([xbc.new_zeros((K - 1, ch)), xbc])
    xbc = sum(padded[k:k + S] * conv_w[k] for k in range(K)) + p["conv_b"].float()
    xbc = torch.nn.functional.silu(xbc)
    xs = xbc[:, :d_in].reshape(S, H, P)
    Bg = xbc[:, d_in:d_in + G * N].reshape(S, G, N)
    Cg = xbc[:, d_in + G * N:].reshape(S, G, N)
    dt = torch.nn.functional.softplus(dt + p["dt_bias"].float())
    y = scan(xs, dt, -torch.exp(p["A_log"].float()), Bg, Cg, p["D"].float(),
             conf["chunk_size"]).reshape(S, d_in)
    h = (y * torch.nn.functional.silu(z)).reshape(S, G, d_in // G)
    h = rms_norm(h, p["norm_scale"].reshape(G, d_in // G), conf["layer_norm_epsilon"])
    return lin(h.reshape(S, d_in), w["out_proj"])


def attention(conf: dict, lin, w: dict, x: torch.Tensor) -> torch.Tensor:
    S = x.shape[0]
    hd, H, Hkv = (conf["attention_head_dim"], conf["num_attention_heads"],
                  conf["num_key_value_heads"])
    q = lin(x, w["wq"]).reshape(S, H, hd)
    k = lin(x, w["wk"]).reshape(S, Hkv, hd)
    v = lin(x, w["wv"]).reshape(S, Hkv, hd)
    return lin(dense.attention(conf, q, k, v), w["wo"])


def layer(conf: dict, lin, kind: str, p: dict, w: dict, x: torch.Tensor) -> torch.Tensor:
    """One layer, ``x + mixer(RMSNorm(x))``, over one sequence x (S, D)."""
    h = rms_norm(x, p["ln1_scale"], conf["layer_norm_epsilon"])
    if kind == MAMBA:
        return x + mamba(conf, lin, p["mamba"], w, h)
    if kind == ATTN:
        return x + attention(conf, lin, w, h)
    return x + lin(torch.relu(lin(h, w["w_up"])).square(), w["w_down"])


@torch.no_grad()
def logits(conf: dict, params: dict, seqs, positions, *, precision: str = "fp32"):
    """Float32 logits of each sequence in ``seqs`` (1-D int tensors on the
    weights' device) at its ``positions``: a list of (len(positions[i]),
    vocab) tensors. Runs layer by layer over all the sequences, each
    layer's matrices upcast (and, for the control, rounded) once."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        lin = dense.Linear(precision)
        xs = [params["embed"][s.long()].to(torch.float32) for s in seqs]
        parts = {MAMBA: "mamba", MLP: "mlp", ATTN: "attn"}
        for kind, blk in zip(kinds(conf), params["blocks"]):
            w = {n: lin.weight(t) for n, t in blk[parts[kind]].items()
                 if n in ("in_proj", "out_proj", "w_up", "w_down", "wq", "wk", "wv", "wo")}
            xs = [layer(conf, lin, kind, blk, w, x) for x in xs]
            del w
        head = params["embed"].T if conf["tie_word_embeddings"] else params["head"]
        head = lin.weight(head)
        eps = conf["layer_norm_epsilon"]
        return [lin(rms_norm(x[list(pos)], params["final_scale"], eps), head)
                for x, pos in zip(xs, positions)]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
