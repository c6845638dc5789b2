"""Model assembly: the decoder LM over superblocks.

The port of ``repro/models/transformer.py``. Parameters keep the
reference's tree: per-layer leaves stacked on a leading layer axis under
``"sb<i>"`` / ``"b<j>"`` / ``"f<j>"``, so a JAX tree converts leaf for
leaf (``convert.lm_params_from_jax``); the layers run in a Python loop
over views of those stacks (PyTorch runs eagerly: no ``scan``). Every
block kind of the reference runs: attention (``layers``), Mamba
(``mamba``), mLSTM and sLSTM (``xlstm``), with dense or MoE (``moe``)
FFNs; inputs are tokens, frame or patch embeddings (musicgen), or
embeddings as a prefix of tokens (pixtral's image prefix).

Entry points:
  init_params(...)      parameters from a seeded ``torch.Generator``, and
                        the logical-axes table (path → axes)
  abstract_params(...)  the same tree on the ``meta`` device, and the axes
  forward(...)          full-sequence logits
  init_decode_state     static-size per-layer caches (KV, recurrent state)
  prefill(...)          populate caches from a prompt
  decode_step(...)      one-token serve step (caches updated in place)
  loss_fn(...)          the masked token cross-entropy (training)

``backend`` ("auto" | "torch" | "cuda") picks the flash attention kernel or
its plain version for the full-sequence attention calls
(``kernels.ops.resolve_backend``); under autograd the kernel path runs the
forward and backward kernels (``layers.grouped_attention``).
``forward(remat=True)`` is the reference's ``jax.checkpoint`` of one
superblock repeat: ``torch.utils.checkpoint`` around each repeat, which
saves the repeat's input and recomputes its inside in the backward.

Under a mesh (``dist.sharding_ctx``, DTensor parameters from
``dist.distribute_params``) the activations pass through ``shard_act`` at
the reference's sites: the embedded input, the residual stream after each
superblock repeat (``seq_sp``: Megatron-SP), the logits; the loss's
log-sum-exp then runs over the vocabulary's shards (:class:`_LogSumExp`).

A stacked leaf may also be a tuple of per-layer tensors (``t[r]`` reads
either): the LM training step hands the model per-layer leaves that share
the stacks' storage, so that autograd returns one gradient per layer
(``train.loop``).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import is_dtensor, shard_act
from . import layers, mamba, moe, xlstm
from .common import (ModelConfig, ParamCtx, ShapeCtx, SuperBlock, matmul,
                     rms_norm)

BLOCK_INIT = {"attn": layers.attn_init, "mamba": mamba.mamba_init,
              "mlstm": xlstm.mlstm_init, "slstm": xlstm.slstm_init}
BLOCK_STEP = {"attn": layers.attn_step, "mamba": mamba.mamba_step,
              "mlstm": xlstm.mlstm_step, "slstm": xlstm.slstm_step}
FFN_INIT = {"dense": layers.ffn_init, "moe": moe.moe_init}
FFN_FWD = {"dense": layers.ffn_fwd, "moe": moe.moe_fwd}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block or FFN kind the model does not
    know (every config in ``configs.ARCHS`` passes)."""
    for sb in cfg.superblocks:
        for kind, ffn in sb.blocks:
            if kind not in BLOCK_INIT:
                raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
            if ffn not in FFN_INIT and ffn != "none":
                raise ValueError(f"{cfg.name}: unknown FFN kind {ffn!r}")


def _block_fwd(kind: str, p, cfg, x, positions, backend: str):
    if kind == "attn":
        return layers.attn_fwd(p, cfg, x, positions, backend=backend)
    if kind == "mamba":
        return mamba.mamba_fwd(p, cfg, x)
    if kind == "mlstm":
        return xlstm.mlstm_fwd(p, cfg, x)
    if kind == "slstm":
        return xlstm.slstm_fwd(p, cfg, x)
    raise ValueError(kind)


def _block_cache(kind: str, cfg, batch, cache_len, dtype, device) -> dict:
    if kind == "attn":
        return layers.attn_init_cache(cfg, batch, cache_len, dtype, device)
    if kind == "mamba":
        return mamba.mamba_init_cache(cfg, batch, dtype, device)
    if kind == "mlstm":
        return xlstm.mlstm_init_cache(cfg, batch, dtype, device)
    if kind == "slstm":
        return xlstm.slstm_init_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def _recurrent_prefill(kind: str, p, cfg, x):
    if kind == "mamba":
        return mamba.mamba_prefill(p, cfg, x)
    if kind == "mlstm":
        return xlstm.mlstm_prefill(p, cfg, x)
    if kind == "slstm":
        return xlstm.slstm_prefill(p, cfg, x)
    raise ValueError(kind)


def _layers(params: dict, cfg: ModelConfig
            ) -> Iterator[Tuple[str, int, str, str, dict, str, dict]]:
    """Every sub-layer in order: (superblock key, layer index, block key,
    block kind, block params, FFN kind, FFN params), the params as
    views."""
    for si, sb in enumerate(cfg.superblocks):
        stack = params[f"sb{si}"]
        for r in range(sb.repeat):
            for bi, (kind, ffn) in enumerate(sb.blocks):
                blk = {k: t[r] for k, t in stack[f"b{bi}"].items()}
                fp = ({k: t[r] for k, t in stack[f"f{bi}"].items()}
                      if ffn in FFN_FWD else {})
                yield f"sb{si}", r, f"b{bi}", kind, blk, ffn, fp


def _ffn(ffn: str, fp: dict, cfg: ModelConfig, x: torch.Tensor
         ) -> torch.Tensor:
    return FFN_FWD[ffn](fp, cfg, x) if ffn in FFN_FWD else x


def _repeats(params: dict, cfg: ModelConfig
             ) -> Iterator[Tuple[SuperBlock, dict]]:
    """Every repeat of every superblock in order: (superblock, the
    repeat's params ``{"b<j>" / "f<j>": {leaf: view}}``)."""
    for si, sb in enumerate(cfg.superblocks):
        stack = params[f"sb{si}"]
        for r in range(sb.repeat):
            yield sb, {k: {n: t[r] for n, t in d.items()}
                       for k, d in stack.items()}


def _repeat_fwd(sb: SuperBlock, lp: dict, cfg: ModelConfig,
                x: torch.Tensor, positions: torch.Tensor, backend: str
                ) -> torch.Tensor:
    """One repeat of a superblock: the reference's scanned body."""
    for bi, (kind, ffn) in enumerate(sb.blocks):
        x = _block_fwd(kind, lp[f"b{bi}"], cfg, x, positions, backend)
        x = _ffn(ffn, lp.get(f"f{bi}", {}), cfg, x)
    # sequence-parallel residual stream between repeats (what remat saves)
    return shard_act(x, ("batch", "seq_sp", "d_model"))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_tree(cfg: ModelConfig, make_ctx) -> Tuple[dict, dict]:
    """The parameter tree and its logical-axes table, each leaf made by
    ``make_ctx(stack, axes, prefix)``'s ``param`` / ``const`` (drawn, or
    only its shape), the axes keyed by the reference's paths."""
    check_supported(cfg)
    axes: Dict[str, tuple] = {}
    ctx = make_ctx(0, axes, ())
    params: Dict[str, object] = {}
    if not cfg.embedding_inputs:
        params["embed"] = ctx.param("embed", (cfg.vocab, cfg.d_model),
                                    ("vocab", "d_model"), scale=0.02)
    params["final_norm"] = ctx.param("final_norm", (cfg.d_model,),
                                     ("d_model",), init="zeros")
    if not cfg.tie_embeddings:
        params["lm_head"] = ctx.param("lm_head", (cfg.d_model, cfg.vocab),
                                      ("d_model", "vocab"))
    for si, sb in enumerate(cfg.superblocks):
        stacked = make_ctx(sb.repeat, axes, (f"sb{si}",))
        p = {}
        for bi, (kind, ffn) in enumerate(sb.blocks):
            with stacked.scope(f"b{bi}"):
                p[f"b{bi}"] = BLOCK_INIT[kind](stacked, cfg)
            if ffn in FFN_INIT:
                with stacked.scope(f"f{bi}"):
                    p[f"f{bi}"] = FFN_INIT[ffn](stacked, cfg)
        params[f"sb{si}"] = p
    return params, axes


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda"
                ) -> Tuple[dict, dict]:
    """Random parameters on ``device`` from ``torch.Generator(seed)`` with
    the reference's distributions (``ParamCtx``), in ``cfg.dtype``; returns
    ``(params, axes)``, ``axes`` the logical-axes table (slash-joined path
    → axes) that ``dist.param_shardings`` reads."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return _init_tree(cfg, lambda stack, axes, prefix: ParamCtx(
        gen, cfg.param_dtype, device, stack=stack, axes=axes, prefix=prefix))


def abstract_params(cfg: ModelConfig) -> Tuple[dict, dict]:
    """``(params, axes)`` as :func:`init_params` returns them, every leaf an
    empty tensor on the ``meta`` device in ``cfg.dtype``: nothing
    allocated (the dry run's path)."""
    shapes, axes = _init_tree(cfg, ShapeCtx)

    def meta(tree):
        return {k: meta(v) if isinstance(v, dict)
                else torch.empty(v, dtype=cfg.param_dtype, device="meta")
                for k, v in tree.items()}
    return meta(shapes), axes


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's leaf shapes (the JAX tree's), nothing
    allocated."""
    return _init_tree(cfg, ShapeCtx)[0]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict
                  ) -> torch.Tensor:
    """batch: ``{"tokens": [B, S]}`` (integer ids) and/or ``{"embeds": [B,
    Se, d_model]}`` (frames or patches of a stub frontend), cast to
    ``cfg.dtype``; with both, the embeddings are the sequence's prefix."""
    dev = params["final_norm"].device
    parts = []
    if batch.get("embeds") is not None:
        parts.append(_on(batch["embeds"], dev).to(cfg.param_dtype))
    if batch.get("tokens") is not None:
        tokens = _on(batch["tokens"], dev)
        parts.append(_lookup(params["embed"], tokens.long(),
                             cfg.param_dtype))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return shard_act(x, ("batch", "seq", "d_model"))


def _lookup(table: torch.Tensor, tokens: torch.Tensor, dtype
            ) -> torch.Tensor:
    """``table.to(dtype)[tokens]``, on plain tensors and DTensors alike
    through ``local_map`` (which hands plain tensors to the local function
    as they are). On a DTensor table each rank looks up in its own
    vocabulary shard, 0 for a token outside it (a partial sum over the
    vocabulary's mesh dim, reduced by the caller's ``shard_act``); neither
    the lookup nor its backward's accumulation holds the whole table."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, split = None, []
    tp = ip = op = tg = ()
    if is_dtensor(table):
        mesh = table.device_mesh
        tp = tuple(p if p == Shard(0) else Replicate()
                   for p in table.placements)
        split = [i for i, p in enumerate(tp) if p == Shard(0)]
        # plain tokens: the same ids on every rank
        ip = tuple(p if p.is_shard() and i not in split else Replicate()
                   for i, p in enumerate(tokens.placements)) if is_dtensor(
            tokens) else (Replicate(),) * mesh.ndim
        op = tuple(Partial() if i in split else p for i, p in enumerate(ip))
        # the table's gradient is a partial sum over the tokens' shards
        tg = tuple(Partial() if p.is_shard() else t for p, t in zip(ip, tp))

    def local(tab, tok):
        off = mesh.get_coordinate()[split[0]] * tab.shape[0] if split else 0
        idx = tok - off
        inside = (idx >= 0) & (idx < tab.shape[0])
        rows = tab.to(dtype)[idx.clamp(0, tab.shape[0] - 1)]
        return torch.where(inside[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
    return local_map(local, out_placements=(op,), in_placements=(tp, ip),
                     in_grad_placements=(tg, ip), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def _on(x, dev) -> torch.Tensor:
    """An array as a tensor on ``dev``; a DTensor as it is."""
    return x if is_dtensor(x) else torch.as_tensor(x, device=dev)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return shard_act(matmul(x, head),
                     ("batch", "seq", "vocab"))


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = False, backend: str = "auto") -> torch.Tensor:
    """Full-sequence logits ``[B, S, vocab]``. ``remat`` checkpoints each
    superblock repeat (module doc); the result is bitwise the same."""
    x = _embed_inputs(params, cfg, batch)
    positions = _positions(x)
    for sb, lp in _repeats(params, cfg):
        if remat:
            x = checkpoint(_repeat_fwd, sb, lp, cfg, x, positions, backend,
                           use_reentrant=False)
        else:
            x = _repeat_fwd(sb, lp, cfg, x, positions, backend)
    return _logits(params, cfg, x)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = False, backend: str = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy in fp32 over the labels ``>= 0``
    (``batch["labels"] [B, St]``; the sum divided by ``max(count, 1)``).
    With both embeddings and tokens only the token suffix counts. No MoE
    auxiliary loss: the reference's loss has none."""
    logits = forward(params, cfg, batch, remat=remat, backend=backend)
    labels = _on(batch["labels"], logits.device)
    if batch.get("embeds") is not None and batch.get("tokens") is not None:
        logits = logits[:, -labels.shape[1]:]        # VLM: the token suffix
    mask = (labels >= 0).float()
    logits = logits.float()
    lse = _LogSumExp.apply(logits)
    gold = _gold(logits, labels.clamp(min=0).long())
    return _total((lse - gold) * mask) / torch.clamp(_total(mask), min=1.0)


def _total(x: torch.Tensor) -> torch.Tensor:
    """``torch.sum(x)``; on a DTensor each rank sums its shard (a partial
    sum over the mesh dims that split x), so that the backward hands each
    rank the gradient of its own shard rather than of the whole."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    xp = op = ()
    if is_dtensor(x):
        xp = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        op = tuple(Partial() if p.is_shard() else Replicate() for p in xp)
    return local_map(torch.sum, out_placements=(op,), in_placements=(xp,),
                     redistribute_inputs=True)(x)


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``, on plain tensors and DTensors alike (as
    :func:`_lookup`). On DTensor logits each rank gathers from its own
    vocabulary shard, taking 0 for a label outside it (a partial sum over
    the vocabulary's mesh dim), so that neither the gather nor its
    backward's scatter ever holds the whole vocabulary."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, split = None, []
    lp = tp = op = ()
    if is_dtensor(logits):
        mesh, vdim = logits.device_mesh, logits.ndim - 1
        lp = tuple(p if p.is_shard() else Replicate()
                   for p in logits.placements)
        tp = tuple(Replicate() if p == Shard(vdim) else p for p in lp)
        op = tuple(Partial() if p == Shard(vdim) else p for p in lp)
        split = [i for i, p in enumerate(lp) if p == Shard(vdim)]
        if not is_dtensor(labels):          # the same labels on every rank
            labels = DTensor.from_local(labels, mesh,
                                        (Replicate(),) * mesh.ndim)

    def local(lg, lab):
        off = (mesh.get_coordinate()[split[0]] * lg.shape[-1]) if split else 0
        idx = lab - off
        inside = (idx >= 0) & (idx < lg.shape[-1])
        g = lg.gather(-1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, g, torch.zeros((), dtype=g.dtype,
                                                  device=g.device))
    return local_map(local, out_placements=(op,), in_placements=(lp, tp),
                     device_mesh=mesh, redistribute_inputs=True)(logits,
                                                                 labels)


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp(x, -1)`` as its ATen implementation computes it
    (``log(Σ exp(x - max)) + max``, an infinite max taken as 0) and
    differentiates it (``grad · exp(x - result)``), written out so
    that on a DTensor split over the last dim the max and the sum reduce
    across the shards (two all-reduces of one value per row) instead of
    gathering the vocabulary."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(dim=-1, keepdim=True)
        m = torch.where(m.abs() == float("inf"), 0.0, m)
        # the exp in place, as ATen's: one [.., vocab] temporary
        out = (x - m).exp_().sum(dim=-1).log() + m.squeeze(-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return grad.unsqueeze(-1) * (x - out.unsqueeze(-1)).exp()


# ---------------------------------------------------------------------------
# serving: caches, prefill, decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device="cuda") -> dict:
    """Zero caches, ``{"sb<i>": {"b<j>": {leaf: [repeat, batch, ...]}}}``:
    attention's ``k`` / ``v`` ``[.., cache_len, n_kv, head_dim]`` in
    ``cfg.dtype``, Mamba's ``conv`` / ``ssm``, mLSTM's ``C`` / ``n`` /
    ``m`` and sLSTM's ``c`` / ``n`` / ``h`` / ``m`` (the reference's
    dtypes)."""
    check_supported(cfg)
    state = {}
    for si, sb in enumerate(cfg.superblocks):
        state[f"sb{si}"] = {
            f"b{bi}": {k: torch.stack([t] * sb.repeat)
                       for k, t in _block_cache(kind, cfg, batch, cache_len,
                                                cfg.param_dtype,
                                                device).items()}
            for bi, (kind, _) in enumerate(sb.blocks)}
    return state


def recurrent_leaves(cfg: ModelConfig, state: dict) -> list:
    """The leaves of ``state`` that every decode step advances, whatever
    its position: all but attention's KV caches (a step writes the KV row
    at its position, and running it twice writes the same row)."""
    return [t for si, sb in enumerate(cfg.superblocks)
            for bi, (kind, _) in enumerate(sb.blocks) if kind != "attn"
            for t in state[f"sb{si}"][f"b{bi}"].values()]


def prefill(params: dict, cfg: ModelConfig, batch: dict, cache_len: int, *,
            backend: str = "auto") -> Tuple[torch.Tensor, dict]:
    """Run the prompt through the model: (logits of the last position
    ``[B, 1, vocab]``, decode state: the prompt's KV cached, each
    recurrent block's final state). As in the reference, a Mamba block's
    conv window holds the prompt's last ``mamba_conv - 1`` inputs, fewer
    for a shorter prompt (a state no decode step takes)."""
    x = _embed_inputs(params, cfg, batch)
    positions = _positions(x)
    per_layer: Dict[Tuple[str, str], list] = {}
    for sk, _, bk, kind, bp, ffn, fp in _layers(params, cfg):
        if kind == "attn":
            x, st = layers.attn_prefill(bp, cfg, x, positions, cache_len,
                                        backend=backend)
        else:
            x, st = _recurrent_prefill(kind, bp, cfg, x)
        per_layer.setdefault((sk, bk), []).append(st)
        x = _ffn(ffn, fp, cfg, x)
    state: Dict[str, dict] = {}
    for (sk, bk), sts in per_layer.items():
        state.setdefault(sk, {})[bk] = {
            name: torch.stack([st[name] for st in sts]) for name in sts[0]}
    return _logits(params, cfg, x[:, -1:]), state


def decode_step(params: dict, cfg: ModelConfig, state: dict, batch: dict,
                pos) -> Tuple[torch.Tensor, dict]:
    """One token for the whole batch: ``batch = {"tokens": [B, 1]}`` or
    ``{"embeds": [B, 1, d_model]}``; ``pos`` the count of already-cached
    tokens (scalar or per slot ``[B]``). Writes every block's new state
    into ``state`` in place and returns (logits ``[B, 1, vocab]``,
    state)."""
    x = _embed_inputs(params, cfg, batch)
    pos = torch.as_tensor(pos, device=x.device)
    for sk, r, bk, kind, bp, ffn, fp in _layers(params, cfg):
        cache = {k: t[r] for k, t in state[sk][bk].items()}
        x, _ = BLOCK_STEP[kind](bp, cfg, x, cache, pos)
        x = _ffn(ffn, fp, cfg, x)
    return _logits(params, cfg, x), state
