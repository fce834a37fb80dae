"""granite-4.0-h (hf ``granitemoehybrid``): Mamba-2 and attention layers
in a fixed pattern, each followed by a mixture of experts with a shared
expert.  The port's own family: the JAX package has none.

Layer i (``cfg.attn_layer_ids`` names the attention layers, every other
one is Mamba-2), with r = ``residual_multiplier``::

    x = x + r * mixer(rms(x))                             # Mamba-2 or attention
    x = x + r * (moe(rms(x)) + shared(rms(x)))

* the Mamba-2 mixer is ``mamba.Mamba2Mixer``, the one ``ZambaLM`` runs,
  with granite's gated norm (``cfg.mamba_gate_first``: gate, then
  normalise) and the SSD scan at state width N (the kernel takes N up to
  128);
* attention is GQA without bias and without any position encoding
  (NoPE: the family's attention layers take no rotary), its scores
  scaled by ``attention_scale``:
  ``ops.attention`` in prefill, ``ops.decode_attention`` over the K/V
  cache in decode;
* the MoE is ``layers.moe_block`` (top-k of E by the router's softmax,
  the gates renormalised over the k: the softmax over the top-k logits),
  the shared expert ``layers.mlp_block`` at width ``shared_ff``;
* the token embedding is multiplied by ``embedding_multiplier``; the
  logits are divided by ``logits_scaling``, applied to the final norm's
  output: ``forward`` returns the hidden states so scaled, so that
  ``unembed`` of them is the model's logits (by 16, a power of two, the
  division is exact in bf16).

Each block's output is multiplied by r (one elementwise product) and
handed to the next norm as ``delta``; ``apply_add_norm`` adds it to the
residual and normalises the sum, one kernel launch on the card, as in
``DecoderLM``.

Parameters: ``embed``, ``mamba`` (the Mamba layers' leaves stacked
``[Lm, ...]``: ``ln1``, the mixer's, ``ln2``, ``moe``, ``shared``),
``attn`` (the attention layers' stacked ``[La, ...]``: ``ln1``, ``attn``,
``ln2``, ``moe``, ``shared``) and ``final_norm``.  Every leaf is read as
stored and cast to the compute dtype at use; the norms, the router and
the mixer's ``A_log``, ``D``, ``dt_bias`` and gated-norm weight stay
fp32 (``FP32_KEYS``), in prefill as in decode.

Cache: ``ssm`` ``[Lm, B, H, P, N]`` fp32, ``conv`` ``[Lm, B, K - 1,
conv_dim]``, ``k``/``v`` ``[La, B, S, Hkv, dh]`` and ``lengths`` ``[B]``;
every leaf has its logical ``batch`` axis, so the engine copies slots as
for the other families.  ``decode_step`` writes the states and the new
K/V into the cache in place, the K/V at the last position past
``max_seq``, as ``DecoderLM`` does.  One device: ``rules`` must be None
(no sharded layout is defined for this family).

On a card ``decode_step`` replays a CUDA graph of itself: the step's ~4,000 launches enqueue on the host at
~65 ms a 32-slot step on an H100's host, against the card's 22 ms
bound, so the host would pace the step.  The first call with a given cache, batch and
weights runs the step eagerly on a side stream (its result is that
call's; the side stream's library handles are set up by it) and then
captures it there, with ``capture_error_mode="thread_local"`` so that
the engine's prefill threads keep launching on the default stream.
Each later call copies the tokens and the lengths into the graph's
inputs, replays it on the current stream and waits on an event for it
to end; the logits and the new lengths come back as copies of the
graph's outputs, so a caller may keep them across steps.  The wait is
measured, not a formality: when a replayed step's end was left to the
engine's read-back of the logits (a device-to-host copy), its two
prefill threads finished 2 prompts in 10 s beside it, against 10 in 5 s
with the event wait (H100; the read-back releases the interpreter lock,
so the cause is below it).  The same kernels run in the same order, so a
replayed step gives the eager step's bits.  A new cache, batch or
weight storage captures anew, dropping the old graph.  While a profiler
records, the step runs eagerly, so that its spans exist.

While a profiler records, each layer of a decode step is inner spans
(``repro_torch.tracing.inner_span``, with the layer's place as
``layer``): ``mamba`` (a Mamba layer's first norm and mixer) or ``attn``
(an attention layer's first norm and attention), then ``moe`` (the second
norm, ``moe_block`` with its own three spans, and ``moe.shared``, the
shared expert).  Prefill records none.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import tracing
from ..config import ArchConfig
from ..kernels import ops
from .base import LMBase, _stack, _unstack
from .layers import (
    _KV,
    _Q,
    _out,
    _proj,
    _qkv,
    apply_add_norm,
    attn_specs,
    cache_prefix,
    cache_write,
    cdtype,
    embed_specs,
    embed_tokens,
    mlp_block,
    mlp_specs,
    moe_block,
    moe_specs,
    norm_specs,
    ops_impl,
    unembed,
)
from .mamba import Mamba2Mixer
from .spec import ParamSpec
from ..tree import tree_leaves

__all__ = ["GraniteHybridLM"]


def _one_device(rules) -> None:
    if rules is not None:
        raise NotImplementedError("GraniteHybridLM runs on one device (rules=None)")


@dataclass
class _Graph:
    """A captured decode step: what it was captured for, its inputs and
    its outputs (the graph's own storage)."""

    key: tuple
    graph: "torch.cuda.CUDAGraph"
    tokens: torch.Tensor
    lengths: torch.Tensor
    new_lengths: torch.Tensor
    logits: torch.Tensor
    done: "torch.cuda.Event"


class GraniteHybridLM(LMBase):
    FP32_KEYS = ("ln1", "ln2", "final_norm", "router", "A_log", "D", "dt_bias", "gn_w")

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        ids = cfg.attn_layer_ids
        if not (cfg.is_pattern_hybrid and cfg.is_moe):
            raise ValueError(f"{cfg.name}: not a Mamba-2 / attention pattern with MoE")
        if cfg.shared_ff <= 0:
            raise ValueError(f"{cfg.name}: shared_ff 0, but the family has a shared expert")
        if list(ids) != sorted(set(ids)) or not 0 <= ids[0] <= ids[-1] < cfg.n_layers:
            raise ValueError(f"{cfg.name}: attention layers {ids} not in 0..{cfg.n_layers}")
        self.mixer = Mamba2Mixer(cfg)
        self.n_attn = len(ids)
        self.n_mamba = cfg.n_layers - self.n_attn
        self._graph: Optional[_Graph] = None

    # ------------------------------------------------------------------
    def _layer_specs(self, kind: str):
        cfg = self.cfg
        s = {"ln1": norm_specs(cfg)}
        if kind == "mamba":
            s.update(self.mixer.specs())
        else:
            s["attn"] = attn_specs(cfg)
        s["ln2"] = norm_specs(cfg)
        s["moe"] = moe_specs(cfg)
        s["shared"] = mlp_specs(cfg.replace(d_ff=cfg.shared_ff))
        return s

    def param_specs(self):
        return {
            "embed": embed_specs(self.cfg),
            "mamba": _stack(self.n_mamba, self._layer_specs("mamba")),
            "attn": _stack(self.n_attn, self._layer_specs("attn")),
            "final_norm": norm_specs(self.cfg),
        }

    def _walk(self, params):
        """``(kind, layer leaves, index among its kind, place)`` in layer
        order."""
        ids = set(self.cfg.attn_layer_ids)
        mamba = iter(enumerate(_unstack(params["mamba"], self.n_mamba)))
        attn = iter(enumerate(_unstack(params["attn"], self.n_attn)))
        for n in range(self.cfg.n_layers):
            i, lp = next(attn) if n in ids else next(mamba)
            yield ("attn" if n in ids else "mamba"), lp, i, n

    # ------------------------------------------------------------------
    def _scaled(self, y):
        return y * self.cfg.residual_multiplier

    def _embed(self, params, tokens):
        x = embed_tokens(params["embed"], tokens, self.cfg)
        return x * self.cfg.embedding_multiplier

    def _head_in(self, params, x, delta):
        """The final norm of ``x + delta``, divided by ``logits_scaling``."""
        _, x = apply_add_norm(params["final_norm"], x, delta, self.cfg)
        return x / self.cfg.logits_scaling

    def _attention(self, p, h, dt):
        """Full-sequence causal attention -> (output, k, v)."""
        q, k, v = _qkv(p, h, h, dt)
        o = ops.attention(q, k, v, causal=True, scale=self.cfg.attention_scale,
                          impl=ops_impl(self.cfg))
        return _out(o, p["wo"], dt), k, v

    def _attention_step(self, p, h, kc, vc, pos, rows, new_len, dt):
        """One token: its K/V written at ``pos``, attention over the cache."""
        q = _proj(h, p["wq"], dt, None, _Q)
        k, v = _proj(h, p["wk"], dt, None, _KV), _proj(h, p["wv"], dt, None, _KV)
        cache_write(kc, pos, k[:, 0], None, rows)
        cache_write(vc, pos, v[:, 0], None, rows)
        o = ops.decode_attention(q[:, 0], kc, vc, new_len,
                                 scale=self.cfg.attention_scale, impl=ops_impl(self.cfg))
        return _out(o, p["wo"], dt)[:, None, :]

    def _ffn(self, lp, h, spans=False):
        """The routed experts plus the shared one (aux loss dropped)."""
        y = moe_block(lp["moe"], h, self.cfg, None, None, spans)[0]
        with (tracing.inner_span if spans else tracing.no_span)("moe.shared"):
            return y + mlp_block(lp["shared"], h, self.cfg)

    def _forward(self, params, tokens, cache=None):
        """Hidden states [B, S, d] over a whole sequence, divided by
        ``logits_scaling``; with ``cache`` (of :meth:`cache_specs`), each
        layer's states or K/V written into it."""
        dt = cdtype(self.cfg)
        x = self._embed(params, tokens)
        delta = None
        for kind, lp, i, _ in self._walk(params):
            x, h = apply_add_norm(lp["ln1"], x, delta, self.cfg)
            if kind == "mamba":
                out, ssm, conv = self.mixer.forward(lp, h, dt)
                if cache is not None:
                    cache["ssm"][i], cache["conv"][i] = ssm, conv
            else:
                out, k, v = self._attention(lp["attn"], h, dt)
                if cache is not None:
                    cache_prefix(cache["k"][i], k)
                    cache_prefix(cache["v"][i], v)
            x, h2 = apply_add_norm(lp["ln2"], x, self._scaled(out), self.cfg)
            delta = self._scaled(self._ffn(lp, h2))
        return self._head_in(params, x, delta)

    def forward(self, params, tokens):
        """tokens [B, S] -> (hidden [B, S, d] divided by ``logits_scaling``,):
        a tuple led by the hidden states, as the other families' forwards."""
        return (self._forward(params, tokens),)

    # ------------------------------------------------------------------
    def cache_specs(self, batch_size: int, seq_len: int):
        cfg = self.cfg
        dt = cdtype(cfg)
        ssm, conv = self.mixer.state_specs((self.n_mamba,), batch_size, dt)
        kv = ParamSpec(
            (self.n_attn, batch_size, seq_len, cfg.n_kv_heads, cfg.head_dim),
            (None, "batch", "cache_seq", "cache_heads", None),
            "zeros",
            dtype=dt,
        )
        return {
            "ssm": ssm,
            "conv": conv,
            "k": kv,
            "v": kv,
            "lengths": ParamSpec((batch_size,), ("batch",), "zeros", dtype=torch.int32),
        }

    @torch.inference_mode()
    def prefill(self, params, batch, rules=None, max_seq: Optional[int] = None):
        """Full-sequence prefill -> (cache with K/V padded to max_seq,
        last logits [B, V])."""
        _one_device(rules)
        tokens = batch["tokens"]
        B, S = tokens.shape
        max_seq = max_seq or S
        if S > max_seq:
            raise ValueError(f"prompt of {S} tokens past max_seq={max_seq}")
        cache = self.init_cache(B, max_seq, tokens.device)
        x = self._forward(params, tokens, cache)
        cache["lengths"].fill_(S)
        return cache, unembed(params["embed"], x[:, -1:], self.cfg)[:, 0]

    @torch.inference_mode()
    def decode_step(self, params, cache, tokens, rules=None):
        """tokens [B, 1] -> (cache', logits [B, V]), states and K/V
        written in place; on a card a replayed CUDA graph (module doc)."""
        _one_device(rules)
        if tokens.is_cuda and not tracing.recording():
            return self._replay(params, cache, tokens)
        return self._step(params, cache, tokens)

    def _replay(self, params, cache, tokens):
        leaves = tree_leaves(params) + [cache[n] for n in ("ssm", "conv", "k", "v")]
        key = (
            tuple(t.data_ptr() for t in leaves),
            tuple(tokens.shape),
            tokens.dtype,
            cache["lengths"].dtype,
        )
        g = self._graph
        if g is None or g.key != key:
            self._graph = None  # its memory pool goes before the next capture
            return self._capture(key, params, cache, tokens)
        g.tokens.copy_(tokens)
        g.lengths.copy_(cache["lengths"])
        g.graph.replay()
        g.done.record()
        g.done.synchronize()  # the interpreter lock is free meanwhile
        return dict(cache, lengths=g.new_lengths.clone()), g.logits.clone()

    def _capture(self, key, params, cache, tokens):
        """This call's step, eagerly on a side stream, then its capture
        there."""
        cur = torch.cuda.current_stream(tokens.device)
        side = torch.cuda.Stream(tokens.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            new_cache, logits = self._step(params, cache, tokens)
            tok, lens = tokens.clone(), cache["lengths"].clone()
        cur.wait_stream(side)
        for t in (new_cache["lengths"], logits):
            t.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            g_cache, g_logits = self._step(params, dict(cache, lengths=lens), tok)
        cur.wait_stream(side)
        self._graph = _Graph(key, graph, tok, lens, g_cache["lengths"], g_logits,
                             torch.cuda.Event())
        return new_cache, logits

    def _step(self, params, cache, tokens):
        """The eager decode step: on the CPU, under a profiler, and what
        a capture records."""
        cfg = self.cfg
        dt = cdtype(cfg)
        lengths = cache["lengths"]
        kc, vc, ssm, conv = cache["k"], cache["v"], cache["ssm"], cache["conv"]
        B, S = kc.shape[1], kc.shape[2]
        new_len = lengths + 1
        pos = lengths.clamp(0, S - 1).long()  # dynamic_update_slice's clamp
        rows = torch.arange(B, device=lengths.device)
        x = self._embed(params, tokens)
        delta = None
        for kind, lp, i, n in self._walk(params):
            with tracing.inner_span(kind, layer=n):
                x, h = apply_add_norm(lp["ln1"], x, delta, cfg)
                if kind == "mamba":
                    out, conv[i], ssm[i] = self.mixer.step(lp, h, conv[i], ssm[i], dt)
                else:
                    out = self._attention_step(
                        lp["attn"], h, kc[i], vc[i], pos, rows, new_len, dt
                    )
            with tracing.inner_span("moe", layer=n):
                x, h2 = apply_add_norm(lp["ln2"], x, self._scaled(out), cfg)
                delta = self._scaled(self._ffn(lp, h2, spans=True))
        logits = unembed(params["embed"], self._head_in(params, x, delta), cfg)
        return dict(cache, lengths=new_len), logits[:, 0]
