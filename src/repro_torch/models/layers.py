"""Shared model layers (the JAX package's ``models/layers.py``),
functional over parameter dicts.

Conventions, as in the reference:
  * weights store contraction dims first: ``wq (D, H, Dh)``,
    ``wo (H, Dh, D)``; a stack of layers has a leading "layers" axis;
  * attention tensors are (B, H, S, Dh);
  * norms, rope, softmax and the loss compute in float32;
  * attention has a full-sequence path (train and prefill) and a
    one-token decode path over a position-tagged KV cache, linear or
    rolling (sliding window).

Activations are wrapped in ``shard_act`` at the reference's sites (a
no-op outside a sharding resolver context; inside one, a DTensor
redistribution). The small tensors the layers make themselves
(positions, masks) join a DTensor step replicated
(:func:`~repro_torch.distributed.actctx.on_mesh_of`). The reference's
``xscan`` is a Python loop here, ``jax.checkpoint`` is
``torch.utils.checkpoint`` (:mod:`repro_torch.models.remat`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .dots import einsum
from ..distributed.actctx import (along, is_sharded, on_mesh_of,
                                  reduce_partial, reshape, shard_act)
from ..kernels.flash_attention import flash_attention
from .config import ModelConfig
from .params import ParamDef, ShapeDtype

__all__ = ["ACT_BSD", "ACT_KVHEADS", "ACT_QHEADS", "KVCacheSpec", "apply_mlp", "apply_norm", "apply_rope",
           "attention_decode", "attention_defs", "attention_full",
           "checkpointed", "cross_entropy_loss", "decode_position",
           "embed_tokens", "embedding_defs", "logits_fn", "mlp_defs",
           "next_token_targets", "norm_defs", "sinusoidal_at",
           "sinusoidal_positions"]

NEG_INF = -1e30


def checkpointed(fn, *args):
    """``fn(*args)`` that keeps only its inputs for the backward pass and
    recomputes the rest (the reference's ``jax.checkpoint`` with the
    ``nothing_saveable`` policy). The model draws no random numbers, so
    no RNG state is saved. Without grad mode (prefill, decode) nothing
    would be kept, so ``fn`` just runs: a process's first checkpoint
    imports ``torch._dynamo``, seconds of host time that would land in
    the first long prefill."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_defs(cfg: ModelConfig, d: int | None = None) -> ParamDef:
    return ParamDef(shape=(d or cfg.d_model,), logical=("embed_r",),
                    init="ones", dtype=cfg.tdtype)


def apply_norm(scale: torch.Tensor, x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    x32 = x.float()
    if cfg.norm == "layernorm":
        x32 = x32 - x32.mean(dim=-1, keepdim=True)
    var = x32.square().mean(dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + cfg.norm_eps)
    return (x32 * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def _rope_freqs(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, S, Dh); positions: (S,) or (B, S)."""
    dh = x.shape[-1]
    freqs = on_mesh_of(_rope_freqs(dh, theta, x.device),
                       positions)                          # (Dh/2,)
    angles = positions[..., None].float() * freqs          # (..., S, Dh/2)
    if angles.dim() == 2:                                  # (S, Dh/2)
        angles = angles[None, None]                        # (1, 1, S, Dh/2)
    else:                                                  # (B, S, Dh/2)
        angles = angles[:, None]                           # (B, 1, S, Dh/2)
    cos = on_mesh_of(torch.cos(angles), x)
    sin = on_mesh_of(torch.sin(angles), x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int,
                         device: "str | torch.device | None" = None
                         ) -> torch.Tensor:
    """Whisper-style sinusoidal table (n, d), float32 (computed, not
    learned)."""
    return sinusoidal_at(torch.arange(n, dtype=torch.float32, device=device),
                         d)


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal encoding of a positions tensor of any shape -> (..., d),
    float32: the reference's ops in its order (a 0-d tensor stays on its
    device)."""
    pos = positions.float()[..., None]
    dim = on_mesh_of(torch.arange(0, d, 2, dtype=torch.float32,
                                  device=pos.device), pos)
    angle = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_defs(cfg: ModelConfig, layers: int | None = None,
                   kv_from: int | None = None) -> dict:
    """Param tree for one (stack of) attention layer(s).

    ``layers``: if given, stack with a leading "layers" axis.
    ``kv_from``: width of the kv source (cross-attention); default d_model.
    """
    D, H, Hk, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
    Dkv = kv_from or D
    lead = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()

    def w(shape, logical):
        return ParamDef(shape=lead + shape, logical=lax_ + logical,
                        dtype=cfg.tdtype)

    return {
        "wq": w((D, H, Dh), ("embed", "heads", "head_dim")),
        "wk": w((Dkv, Hk, Dh), ("embed", "kv_heads", "head_dim")),
        "wv": w((Dkv, Hk, Dh), ("embed", "kv_heads", "head_dim")),
        "wo": w((H, Dh, D), ("heads", "head_dim", "embed")),
    }


ACT_BSD = ("batch", "act_seq", "act_embed")
ACT_QHEADS = ("batch", "heads", "act_seq", "head_dim")
ACT_KVHEADS = ("batch", "kv_heads", "act_seq", "head_dim")


def _qkv(p: dict, x: torch.Tensor, kv_x: torch.Tensor):
    q = shard_act(einsum("bsd,dhk->bhsk", x, p["wq"]), ACT_QHEADS)
    k = shard_act(einsum("bsd,dhk->bhsk", kv_x, p["wk"]), ACT_KVHEADS)
    v = shard_act(einsum("bsd,dhk->bhsk", kv_x, p["wv"]), ACT_KVHEADS)
    return q, k, v


def attention_full(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   kv_x: Optional[torch.Tensor] = None, causal: bool = True,
                   rope: bool = True, window: Optional[int] = None,
                   use_flash: bool = False, block_q: int = 512,
                   block_k: int = 512) -> torch.Tensor:
    """Full-sequence attention (train). x: (B, S, D). ``use_flash`` takes
    the flash kernel (its plain version on CPU tensors)."""
    kv_src = x if kv_x is None else kv_x
    q, k, v = _qkv(p, x, kv_src)
    if rope:
        pos_q = torch.arange(x.shape[1], device=x.device)
        pos_k = torch.arange(kv_src.shape[1], device=x.device)
        q = apply_rope(q, pos_q, cfg.rope_theta)
        k = apply_rope(k, pos_k, cfg.rope_theta)
    if use_flash and kv_x is None:
        out = flash_attention(q, k, v, causal=causal, window=window,
                              bq=block_q, bk=block_k)
    else:
        out = _attend(q, k, v, causal=causal and kv_x is None, window=window)
    return shard_act(einsum("bhsk,hkd->bsd", out, p["wo"]), ACT_BSD)


def _expand_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """GQA: replicate kv heads up to the q-head count (each kv head
    ``h // hkv`` times in a row, as ``jnp.repeat``; by expand and
    reshape, which never waits on the device)."""
    b, hkv, s, dh = k.shape
    if hkv == h:
        return k
    return shard_act(reshape(k[:, :, None].expand(b, hkv, h // hkv, s, dh),
                             (b, h, s, dh)), ACT_QHEADS)


# Sequences at or above this length use the q-chunked path so the (S, S)
# score matrix never materializes whole.
_CHUNK_THRESHOLD = 2048
_Q_CHUNK = 1024


def _attend(q, k, v, *, causal: bool,
            window: Optional[int]) -> torch.Tensor:
    """Attention with GQA head expansion; q-chunked for long sequences."""
    b, h, sq, dh = q.shape
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    if sq >= _CHUNK_THRESHOLD and sq % _Q_CHUNK == 0 \
            and not _seq_sharded(q):
        return _attend_chunked(q, k, v, causal=causal, window=window)
    return _attend_direct(q, k, v, causal=causal, window=window)


def _seq_sharded(q: torch.Tensor) -> bool:
    """Whether a DTensor q splits its sequence over ranks (heads that do
    not divide the model axis leave it to the sequence): each rank then
    holds a slice of the queries already, and cutting the sequence into
    chunks would gather it."""
    return is_sharded(q) and any(getattr(p, "dim", None) == 2
                                 for p in q.placements)


def _attend_direct(q, k, v, *, causal: bool, window: Optional[int],
                   q_offset: Optional[int] = None) -> torch.Tensor:
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    scores = einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float()) / math.sqrt(dh)
    if causal or window is not None:
        dev = q.device
        offset = (sk - sq) if q_offset is None else q_offset  # align ends
        q_pos = torch.arange(sq, device=dev)[:, None] + offset
        k_pos = torch.arange(sk, device=dev)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        scores = torch.where(along(mask, scores, (2, 3)), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = einsum("bhqk,bhkd->bhqd", probs, v.float())
    return shard_act(out.to(q.dtype), ACT_QHEADS)


def _attend_chunked(q, k, v, *, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """Loop over query chunks: the live score slab is (B, H, qc, S), not
    (B, H, S, S). Each chunk is checkpointed, so the backward pass
    re-derives its probabilities instead of keeping them per chunk."""
    qc = _Q_CHUNK

    def body(q_c, i):
        return _attend_direct(q_c, k, v, causal=causal, window=window,
                              q_offset=i * qc)

    outs = [checkpointed(body, q_c, i)
            for i, q_c in enumerate(q.split(qc, dim=2))]
    return torch.cat(outs, dim=2)


# ---- decode path ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Layout of one layer-stack's KV cache: (L, B, Hkv, S, Dh) k/v plus a
    position tag per slot, -1 for an empty one (which is what lets a
    rolling window cache wrap)."""

    layers: int
    batch: int
    kv_heads: int
    length: int
    head_dim: int
    dtype: torch.dtype

    def shape_tree(self) -> dict:
        kv = ShapeDtype(torch.Size((self.layers, self.batch, self.kv_heads,
                                    self.length, self.head_dim)), self.dtype)
        pos = ShapeDtype(torch.Size((self.layers, self.batch, self.length)),
                         torch.int32)
        return {"k": kv, "v": kv, "pos": pos}

    @property
    def logical(self) -> dict:
        kv = ("layers", "cache_batch", "kv_heads", "cache_seq", "head_dim")
        return {"k": kv, "v": kv,
                "pos": ("layers", "cache_batch", "cache_seq")}

    def init_tree(self, device: "str | torch.device" = "cuda") -> dict:
        shapes = self.shape_tree()
        return {
            "k": torch.zeros(shapes["k"].shape, dtype=self.dtype,
                             device=device),
            "v": torch.zeros(shapes["v"].shape, dtype=self.dtype,
                             device=device),
            "pos": torch.full(shapes["pos"].shape, -1, dtype=torch.int32,
                              device=device),
        }


def decode_position(pos, like: "torch.Tensor | torch.device"
                    ) -> torch.Tensor:
    """A decode position as a 0-d tensor on ``like`` (a device, or a
    tensor's device): a tensor passes through as it is (so a CUDA graph
    can advance it in place), a Python int is filled in there by a kernel
    (no copy from the host, so the host does not wait for the stream);
    either joins ``like``'s mesh, replicated, when ``like`` is a
    DTensor."""
    device = like if isinstance(like, torch.device) else like.device
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int64, device=device)
    return pos if isinstance(like, torch.device) else on_mesh_of(pos, like)


def _write_slot(cache: torch.Tensor, dim: int, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache``'s entry ``slot`` along ``dim`` set to ``new`` in place,
    for a cache sharded along that dim: each rank compares its own slots
    with ``slot`` and keeps its entries where they differ (the one rank
    holding the slot writes it; an index copy would need the whole
    dim)."""
    n = cache.shape[dim]
    hit = along(torch.arange(n, device=slot.device), cache, dim) == slot
    hit = hit.reshape((n,) + (1,) * (cache.ndim - dim - 1))
    cache.copy_(torch.where(hit, new.to(cache.dtype), cache))


def attention_decode(p: dict, x: torch.Tensor, layer_cache: dict, pos,
                     cfg: ModelConfig, *, rope: bool = True,
                     window: Optional[int] = None
                     ) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D); ``layer_cache`` holds this layer's
    {k, v, pos} (B, Hkv, S, Dh) / (B, S), views of the stacked cache;
    ``pos`` is an int or a 0-d integer tensor on the cache's device (the
    same result either way; the tensor form never reads the position on
    the host). Returns (y, layer_cache).

    Unlike the reference's functional update, the new K/V and position
    tag are written in place into slot ``pos % S`` of ``layer_cache``'s
    tensors, and the same tensors are returned: a step moves one slot,
    not the whole cache. A linear cache (S = max length) writes slot
    ``pos``; a rolling window cache (S = window) wraps, and the tags mask
    the slots that are empty (tag < 0), ahead (tag > pos) or, with a
    window, out of it (pos - tag >= window)."""
    q, k_new, v_new = _qkv(p, x, x)                      # (B, *, 1, Dh)
    b = x.shape[0]
    pos = decode_position(pos, x)
    if rope:
        pos_b = pos.reshape(1, 1).expand(b, 1)
        q = apply_rope(q, pos_b, cfg.rope_theta)
        k_new = apply_rope(k_new, pos_b, cfg.rope_theta)
    k, v, tags = layer_cache["k"], layer_cache["v"], layer_cache["pos"]
    slot = (pos % k.shape[2]).reshape(1).long()
    tag = pos.reshape(1, 1).expand(b, 1).to(tags.dtype)
    if is_sharded(k):
        _write_slot(k, 2, slot, k_new)
        _write_slot(v, 2, slot, v_new)
        _write_slot(tags, 1, slot, tag)
    else:
        # one rank: every tensor is whole on it (DTensors replicated), so
        # the update runs on the local tensors
        k_l, v_l, t_l, s_l, kn, vn, tg = (
            x.to_local() if type(x).__name__ == "DTensor" else x
            for x in (k, v, tags, slot, k_new, v_new, tag))
        k_l.index_copy_(2, s_l, kn.to(k_l.dtype))
        v_l.index_copy_(2, s_l, vn.to(v_l.dtype))
        t_l.index_copy_(1, s_l, tg)

    h, dh = q.shape[1], q.shape[-1]
    k_exp = _expand_kv(k, h)
    v_exp = _expand_kv(v, h)
    scores = einsum("bhqd,bhkd->bhqk", q.float(),
                          k_exp.float()) / math.sqrt(dh)
    valid = (tags >= 0) & (tags <= pos)
    if window is not None:
        valid &= (pos - tags) < window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = einsum("bhqk,bhkd->bhqd", probs, v_exp.float()).to(x.dtype)
    y = einsum("bhsk,hkd->bsd", out, p["wo"])
    return y, layer_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / plain)
# ---------------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, layers: int | None = None) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    lead = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()

    def w(shape, logical):
        return ParamDef(shape=lead + shape, logical=lax_ + logical,
                        dtype=cfg.tdtype)

    if cfg.mlp_type == "plain":
        return {"w_up": w((D, F_), ("embed", "mlp")),
                "w_down": w((F_, D), ("mlp", "embed"))}
    return {"w_gate": w((D, F_), ("embed", "mlp")),
            "w_up": w((D, F_), ("embed", "mlp")),
            "w_down": w((F_, D), ("mlp", "embed"))}


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    return F.silu(x)


def apply_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    mlp_hidden = ("batch", "act_seq", "mlp")
    if cfg.mlp_type == "plain":
        h = _act(shard_act(einsum("bsd,df->bsf", x, p["w_up"]),
                           mlp_hidden), cfg.act)
        return shard_act(einsum("bsf,fd->bsd", h, p["w_down"]),
                         ACT_BSD)
    g = _act(shard_act(einsum("bsd,df->bsf", x, p["w_gate"]),
                       mlp_hidden), cfg.act)
    u = shard_act(einsum("bsd,df->bsf", x, p["w_up"]), mlp_hidden)
    return shard_act(einsum("bsf,fd->bsd", g * u, p["w_down"]),
                     ACT_BSD)


# ---------------------------------------------------------------------------
# Embedding + LM head + loss
# ---------------------------------------------------------------------------


def embedding_defs(cfg: ModelConfig) -> dict:
    out = {"table": ParamDef(shape=(cfg.vocab_padded, cfg.d_model),
                             logical=("vocab", "embed"), init="embed",
                             scale=0.02, dtype=cfg.tdtype)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef(shape=(cfg.d_model, cfg.vocab_padded),
                                  logical=("embed", "vocab"),
                                  dtype=cfg.tdtype)
    return out


def embed_tokens(p: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    if is_sharded(p["table"]):
        # the vocab-split lookup (DTensor's rule for ``embedding``: each
        # rank looks up its rows, a masked partial sum)
        return shard_act(F.embedding(tokens.long(), p["table"]), ACT_BSD)
    return shard_act(p["table"][tokens.long()], ACT_BSD)


def logits_fn(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return einsum("bsd,vd->bsv", h, p["table"])
    return einsum("bsd,dv->bsv", h, p["lm_head"])


def cross_entropy_loss(p_embed: dict, h: torch.Tensor, targets: torch.Tensor,
                       cfg: ModelConfig, *, chunk: int = 512,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """CE over (B, S) targets, chunked over the sequence so the
    (B, chunk, V) logits slab bounds activation memory; each chunk is
    checkpointed. ``mask`` (B, S) in {0, 1} weights positions. Positions
    past the last whole chunk are dropped, as in the reference."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    n_chunks = s // chunk
    if mask is None:
        mask = torch.ones_like(h[..., 0], dtype=torch.float32)

    def body(hc, tc, mc):
        logits = shard_act(logits_fn(p_embed, hc, cfg),
                           ("batch", None, "vocab")).float()
        if cfg.vocab_padded != cfg.vocab_size:
            col = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(along(col < cfg.vocab_size, logits, -1),
                                 logits, NEG_INF)
        lse = _logsumexp(logits)
        gold = _gold(logits, tc)
        return torch.sum((lse - gold) * mc.float())

    # the chunks are slices of the sequence: on a mesh, gather a
    # sequence-sharded h once here, not once per chunk
    h = shard_act(h, ("batch", None, "act_embed"))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpointed(body, h[:, sl], targets[:, sl],
                                     mask[:, sl])
    return total / torch.clamp(mask.sum(), min=1.0)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim. Over a sharded vocab: the row max
    and the sum of exponentials each reduced across the shards (two
    all-reduces of (B, chunk)), where a whole-row logsumexp would gather
    the logits."""
    if not is_sharded(logits):
        return torch.logsumexp(logits, dim=-1)
    m = reduce_partial(torch.amax(logits, dim=-1, keepdim=True).detach())
    s = reduce_partial(torch.exp(logits - m).sum(-1))
    return torch.log(s) + m[..., 0]


def _gold(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits[..., target]``. Over a sharded vocab each rank picks from
    its own columns and the pick is a partial sum (every other column
    adds an exact zero), where a gather across the shards would need the
    whole row."""
    if not is_sharded(logits):
        return torch.gather(logits, -1, targets[..., None].long())[..., 0]
    col = along(torch.arange(logits.shape[-1], device=logits.device),
                logits, -1)
    return reduce_partial(
        torch.where(col == targets[..., None], logits, 0.0).sum(-1))


def next_token_targets(tokens: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep S intact: targets are tokens rolled left; the final position
    is masked out of the loss."""
    s = tokens.shape[1]
    # ``torch.roll(tokens, -1, dims=1)``, as a slice and a concatenation,
    # which DTensor shards (it has no rule for ``roll`` in torch 2.11)
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    keep = (torch.arange(s, device=tokens.device) < s - 1).float()
    mask = torch.ones_like(tokens, dtype=torch.float32) * on_mesh_of(
        keep, tokens)
    return targets, mask
