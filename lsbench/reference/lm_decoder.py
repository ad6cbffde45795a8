"""Plain reference of the port's decoders: grouped-query (``gqa``) or
multi-head latent (``mla``) attention, chosen by ``arch["attention"]``,
and the ``dense`` family (SwiGLU or tanh-GELU MLP) or the ``moe`` family
(softmax top-k routing, renormalised over the k chosen; each batch row's
(token, choice) pairs binned by expert in token order and cut at the
expert's capacity; the shared experts as one SwiGLU MLP; the
Switch-style load-balancing loss). That is the shape of the port's
registered ``yi-9b``, ``starcoder2-7b``, ``moonshot-v1-16b-a3b`` and
``minicpm3-4b``, not Moonlight-16B-A3B's published one (latent attention
without a query LoRA, sigmoid routing, a leading dense layer, no token
dropped). Another reference under ``reference/`` may import this one
(``from lsbench.reference import lm_decoder``) and replace a part.

The model, from the configuration's ``arch`` (the port's ``ArchConfig``
fields), as ``models/model.py`` and ``models/layers.py`` compute it: the
token embedding; per layer ``x += attn(rmsnorm(x))`` and ``x +=
mlp(rmsnorm(x))``; a final RMSNorm and the output head (``lm_head``, or
the embedding's transpose where tied). RMSNorm is ``x / sqrt(mean(x^2)
+ eps) * scale``; rotary embedding rotates the split halves (x1, x2) at
positions 0..S-1 by angles ``pos / theta^(2i / width)``.

- GQA: q, k, v projections (``wq`` (d, h, k), ``wk``/``wv`` (d, g,
  k)), rotary q and k, causal softmax scaled by 1/sqrt(k), head i reading
  kv group i // (h / g), and ``wo`` (h, k, d).
- MLA: the query ``cq = rmsnorm(q_norm, x w_dq)`` (the query LoRA, rank
  ``q_lora_rank``), ``q = cq w_uq`` (``w_uq`` (r, h, nope + rope)), split
  into ``q_nope`` (the first ``nope_head_dim``) and ``q_rope`` (the
  rest); the key and value latent ``ckv = rmsnorm(kv_norm, x w_dkv)``
  (rank ``kv_lora_rank``), each head's ``k_nope = ckv w_uk`` and ``v =
  ckv w_uv``; the decoupled rotary key ``kr = x w_kr`` (``rope_head_dim``
  wide), one for all heads; rotary ``q_rope`` and ``kr``; scores
  ``(q_nope . k_nope + q_rope . kr) / sqrt(nope + rope)``, causal softmax,
  ``out = probs v`` and ``y = out wo`` (``wo`` (h, v, d)).

The objective is the mean next-token cross-entropy plus ``AUX_WEIGHT``
times the layers' load-balancing losses, each ``sum_e share_e * load_e
* E / k`` over the batch (share: mean router probability; load: mean
count of the expert among a token's k choices).

Departures from MiniCPM3-4B as published (openbmb/MiniCPM3-4B), shared
with the program, none of which changes a width or a count of
operations: no muP-style scalars (``scale_emb`` on the embedding,
``scale_depth / sqrt(layers)`` on each residual branch, the logits over
``hidden_size / dim_model_base``); no long-context scaling of the rotary
frequencies (the plain ``rope_theta`` ones at every position); random
weights drawn from the seed, not the trained ones.

``loss_and_grads(arch, weights, tokens, labels, precision)`` gives the
batch's mean cross-entropy and the objective's gradient for every weight
(named as the port's parameters), with each product in ``precision``:
``float32`` (TF32 off), ``tf32``, ``bfloat16`` (operands and result
rounded to bfloat16) or ``float8`` (operands rounded to float8 e4m3 with
a per-tensor scale, the product in float32). Norms, rotary angles,
softmax, routing and the loss are float32 in every precision.

It runs ``rows`` batch rows at a time, each layer and each block of the
loss under ``torch.utils.checkpoint``, attention and the loss by blocks
of positions, so that it fits beside float32 weights, one gradient and
two moments. The load-balancing loss couples the rows through each
expert's load over the whole batch, which a first pass without
gradients counts. Imports only torch and math.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

AUX_WEIGHT = 0.01
BLOCK = 1024          # positions a block of attention rows or of the loss
FP8_MAX = 448.0       # largest finite float8 e4m3 value


def _set_tf32(matmul: bool, cudnn: bool) -> Tuple[bool, bool]:
    """Turn TF32 products on or off; returns the settings before."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    return was


def _fp8(x: torch.Tensor) -> torch.Tensor:
    if x.numel() == 0:              # an expert no token chose
        return x
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    # Rounded forward, straight through backward.
    return x + (q - x).detach()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x + (x.to(torch.bfloat16).float() - x).detach()


def prod(eq: str, a: torch.Tensor, b: torch.Tensor,
         precision: str) -> torch.Tensor:
    """``einsum(eq, a, b)`` in ``precision``, float32 out."""
    if precision == "bfloat16":
        return _bf16(torch.einsum(eq, _bf16(a), _bf16(b)))
    if precision == "float8":
        a, b = _fp8(a), _fp8(b)
    return torch.einsum(eq, a, b)


def rmsnorm(scale, x, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, K) at positions 0..S-1: (x1, x2) halves rotated."""
    k = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, k, 2, dtype=torch.float32,
                                         device=x.device) / k)
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def causal_blocks(scores, v, s, eq, precision):
    """``probs v`` by blocks of ``BLOCK`` query rows: ``scores(q0, q1)``
    gives the rows' scaled scores (B, H, q1 - q0, q1) against keys 0..q1,
    ``v`` (B, S, H, V) the values; (B, S, H, V)."""
    outs = []
    for q0 in range(0, s, BLOCK):
        q1 = min(q0 + BLOCK, s)
        device = v.device
        causal = (torch.arange(q1, device=device)[None, :]
                  <= torch.arange(q0, q1, device=device)[:, None])
        probs = torch.softmax(scores(q0, q1).masked_fill(~causal,
                                                         -math.inf), -1)
        outs.append(prod(eq, probs, v[:, :q1], precision))
    return torch.cat(outs, 1)


def gqa_attention(p, x, arch, precision):
    h, g = arch["num_heads"], arch["num_kv_heads"]
    q = rope(prod("bsd,dhk->bshk", x, p["wq"], precision), arch["rope_theta"])
    k = rope(prod("bsd,dgk->bsgk", x, p["wk"], precision), arch["rope_theta"])
    v = prod("bsd,dgk->bsgk", x, p["wv"], precision)
    k = k.repeat_interleave(h // g, dim=2)
    v = v.repeat_interleave(h // g, dim=2)
    scale = 1.0 / math.sqrt(q.shape[-1])

    def scores(q0, q1):
        return prod("bqhk,bthk->bhqt", q[:, q0:q1], k[:, :q1],
                    precision) * scale

    out = causal_blocks(scores, v, x.shape[1], "bhqt,bthk->bqhk", precision)
    return prod("bshk,hkd->bsd", out, p["wo"], precision)


def mla_attention(p, x, arch, precision):
    nd, eps = arch["nope_head_dim"], arch["norm_eps"]
    theta = arch["rope_theta"]
    cq = rmsnorm(p["q_norm"], prod("bsd,dc->bsc", x, p["w_dq"], precision),
                 eps)
    q = prod("bsc,chk->bshk", cq, p["w_uq"], precision)
    q_nope, q_rope = q[..., :nd], rope(q[..., nd:], theta)
    ckv = rmsnorm(p["kv_norm"], prod("bsd,dc->bsc", x, p["w_dkv"],
                                     precision), eps)
    k_nope = prod("btc,chn->bthn", ckv, p["w_uk"], precision)
    v = prod("btc,chv->bthv", ckv, p["w_uv"], precision)
    kr = rope(prod("bsd,dr->bsr", x, p["w_kr"], precision)[:, :, None],
              theta)[:, :, 0]
    scale = 1.0 / math.sqrt(q.shape[-1])

    def scores(q0, q1):
        return (prod("bqhn,bthn->bhqt", q_nope[:, q0:q1], k_nope[:, :q1],
                     precision)
                + prod("bqhr,btr->bhqt", q_rope[:, q0:q1], kr[:, :q1],
                       precision)) * scale

    out = causal_blocks(scores, v, x.shape[1], "bhqt,bthv->bqhv", precision)
    return prod("bshv,hvd->bsd", out, p["wo"], precision)


ATTENTION = {"gqa": gqa_attention, "mla": mla_attention}


def mlp(p, x, kind, precision):
    hid = prod("bsd,df->bsf", x, p["w_in"], precision)
    if kind == "swiglu":
        hid = F.silu(prod("bsd,df->bsf", x, p["w_gate"], precision)) * hid
    else:
        hid = F.gelu(hid, approximate="tanh")
    return prod("bsf,fd->bsd", hid, p["w_out"], precision)


def capacity(arch, s: int) -> int:
    """Each expert's places in one row of ``s`` tokens: every choice up to
    512 choices a row (with a factor of at least 1), else
    ``round(choices / E * factor)``."""
    tk = s * arch["experts_per_token"]
    factor = arch["moe_capacity_factor"]
    if tk <= 512 and factor >= 1.0:
        return tk
    return int(max(1, round(tk / arch["num_experts"] * factor)))


def route(p, x, arch):
    """(router probabilities (B, S, E), gate weights (B, S, k), chosen
    experts (B, S, k)), float32."""
    probs = torch.softmax(torch.einsum("bsd,de->bse", x, p["router"]), -1)
    gate, idx = torch.topk(probs, arch["experts_per_token"], dim=-1)
    return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), idx


def experts(p, x, gate, idx, arch, precision):
    """Each token's gated sum over its kept choices of the experts'
    SwiGLU outputs; a row's choices past an expert's capacity (counted in
    token order, then choice order) add nothing."""
    b, s, d = x.shape
    e, k = arch["num_experts"], arch["experts_per_token"]
    onehot = F.one_hot(idx, e).reshape(b, s * k, e)
    kept = ((onehot.cumsum(1) <= capacity(arch, s)) & onehot.bool()).any(-1)
    kept = kept.reshape(b * s * k)
    weight = gate.reshape(b * s * k)
    flat_e, xs = idx.reshape(b * s * k), x.reshape(b * s, d)
    tok = torch.arange(b * s, device=x.device).repeat_interleave(k)
    y = torch.zeros_like(xs)
    for j in range(e):
        at = torch.nonzero((flat_e == j) & kept)[:, 0]
        xin = xs[tok[at]][None]
        hid = F.silu(prod("bsd,df->bsf", xin, p["w_gate"][j], precision)) \
            * prod("bsd,df->bsf", xin, p["w_in"][j], precision)
        out = prod("bsf,fd->bsd", hid, p["w_out"][j], precision)[0]
        y = y.index_add(0, tok[at], out * weight[at, None])
    return y.reshape(b, s, d)


def layer(p, x, arch, precision):
    """One block: (x, the router probabilities summed over the rows'
    tokens (E,), the count of each expert among the rows' choices (E,))."""
    eps = arch["norm_eps"]
    attn = ATTENTION[arch["attention"]]
    x = x + attn(p["attn"], rmsnorm(p["ln1"], x, eps), arch, precision)
    hid = rmsnorm(p["ln2"], x, eps)
    if arch["family"] != "moe":
        return x + mlp(p["mlp"], hid, arch["mlp_type"], precision), None, None
    probs, gate, idx = route(p["moe"], hid, arch)
    y = experts(p["moe"], hid, gate, idx, arch, precision)
    if "shared" in p["moe"]:
        y = y + mlp(p["moe"]["shared"], hid, "swiglu", precision)
    count = F.one_hot(idx, arch["num_experts"]).sum((0, 1, 2)).float()
    return x + y, probs.sum((0, 1)), count


def nll_block(final_norm, head, x, labels, arch, precision):
    """Sum of the next-token NLL over a block of positions."""
    logits = prod("bsd,dv->bsv", rmsnorm(final_norm, x, arch["norm_eps"]),
                  head, precision)
    return (torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels[..., None].long())[..., 0]).sum()


def nll_sum(final_norm, head, x, labels, arch, precision):
    """Sum over the rows' tokens of the next-token NLL, by blocks of
    positions, each recomputed in the backward (a block's logits, not
    all of them, are alive at a time)."""
    total = x.new_zeros(())
    for s0 in range(0, x.shape[1], BLOCK):
        args = (final_norm, head, x[:, s0:s0 + BLOCK],
                labels[:, s0:s0 + BLOCK], arch, precision)
        total = total + (checkpoint(nll_block, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else nll_block(*args))
    return total


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"layers.0.attn.wq": t} -> {"layers": {"0": {"attn": {"wq": t}}}}."""
    out: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return out


def supported(arch) -> None:
    """Refuse a shape this reference does not compute."""
    mla = arch["attention"] == "mla"
    if arch["attention"] not in ATTENTION \
            or arch["family"] not in ("dense", "moe") \
            or (mla and (arch["family"] != "dense"
                         or arch["mlp_type"] != "swiglu"
                         or not arch["q_lora_rank"])):
        raise NotImplementedError(
            f"lm_decoder computes GQA dense and moe decoders and dense "
            f"SwiGLU MLA decoders with a query LoRA, not {arch['attention']} "
            f"{arch['family']} {arch['mlp_type']} q_lora_rank "
            f"{arch.get('q_lora_rank')}")


def forward(p, tokens, labels, arch, precision, load=None):
    """(NLL summed over the rows, the load-balancing terms summed over the
    layers, each expert's count per layer)."""
    supported(arch)
    x = p["embed"][tokens.long()]
    aux, counts = x.new_zeros(()), []
    n_layers = len(p["layers"])
    for i in range(n_layers):
        lp = p["layers"][str(i)]
        if torch.is_grad_enabled():
            x, share, count = checkpoint(layer, lp, x, arch, precision,
                                         use_reentrant=False)
        else:
            x, share, count = layer(lp, x, arch, precision)
        if share is not None:
            counts.append(count)
            if load is not None:
                e, k = arch["num_experts"], arch["experts_per_token"]
                aux = aux + (share * load[i]).sum() * e / k
    head = p["embed"].T if arch.get("tie_embeddings") else p["lm_head"]
    return nll_sum(p["final_norm"], head, x, labels, arch, precision), aux, \
        counts


def loss_and_grads(arch: dict, weights: Dict[str, torch.Tensor],
                   tokens: torch.Tensor, labels: torch.Tensor,
                   precision: str = "float32", rows: int = 1
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean cross-entropy, gradient of the objective by weight name) of
    float32 ``weights`` on ``tokens`` (B, S) and ``labels`` (B, S)."""
    n = tokens.numel()
    tf32 = precision == "tf32"
    was = _set_tf32(tf32, tf32)
    try:
        leaves = {k: w.detach().requires_grad_() for k, w in weights.items()}
        p = nest(leaves)
        load = None
        if arch["family"] == "moe":
            with torch.no_grad():
                per_layer = None
                for r in range(0, tokens.shape[0], rows):
                    _, _, counts = forward(p, tokens[r:r + rows],
                                           labels[r:r + rows], arch,
                                           precision)
                    per_layer = counts if per_layer is None else [
                        a + c for a, c in zip(per_layer, counts)]
            load = [c / n for c in per_layer]
        loss = 0.0
        for r in range(0, tokens.shape[0], rows):
            nll, aux, _ = forward(p, tokens[r:r + rows], labels[r:r + rows],
                                  arch, precision, load)
            (nll / n + AUX_WEIGHT * aux / n).backward()
            loss += float(nll.detach()) / n
    finally:
        _set_tf32(*was)
    grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
             for k, t in leaves.items()}
    for t in leaves.values():
        t.grad = None
        t.requires_grad_(False)
    return loss, grads
