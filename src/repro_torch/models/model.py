"""The language models as ``nn.Module``s and their chunked softmax-xent
loss — the counterpart of ``repro.models.model``: :class:`DecoderLM` for
the dense and MoE families (full, sliding-window and gemma2's local/global
attention; softcaps; q/k/v biases), the SSM family (xlstm's mLSTM and
sLSTM blocks), the hybrid family (zamba2's Mamba2 blocks and its
weight-shared attention block) and the VLM family (pixtral: a dense
decoder whose projected patch embeddings are prepended to the text), and
:class:`EncDecLM` for the encoder-decoder audio family (seamless) — each
with the serving calls ``prefill``, ``decode_step``, ``init_caches`` and
``cache_specs``.

Parameters keep the reference's paths and stacked shapes (``embed.table``,
``head.w``, ``stack.blocks.b0.attn.wq`` of shape ``(n, d, H*hd)`` over the
``n`` superblocks, ``projector.w``, ``encdec.decoder.xattn.wq`` over the
decoder rows, ...).  ``named_leaves`` lists them in the reference's leaf
order, which is ``jax.tree_util.tree_leaves`` of the nested dict:
keys sorted at every level (``router, shared, w_down, w_gate, w_up`` under
``moe``).  The bucket plan, the optimizer and the EF residuals all follow
that order.  As in the reference, the output head is untied and the vocab
is padded to a multiple of 128; the MoE router, the SSD block's
``wdt``/``A_log``/``D``/``dt_bias``, the mLSTM's gate weights and biases
and the sLSTM's biases are f32 whatever the parameter dtype.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import encdec as encdec_mod
from . import moe as moe_mod
from . import multimodal
from . import ssm as ssm_mod
from . import transformer
from . import xlstm as xlstm_mod
from .layers import embed, normal_init, softcap, truncated_normal_init


LONG_CONTEXT_WINDOW = 8192  # sliding-window variant used for long_500k


def padded_vocab(cfg: ArchConfig) -> int:
    return int(math.ceil(cfg.vocab_size / 128) * 128)


def long_context_variant(cfg: ArchConfig) -> ArchConfig:
    """The sliding-window variant that makes a full-attention arch runnable
    at 500k decode, as the reference picks it: gemma2's local layers keep
    their window (its global layers stay full), every other attention arch
    gets an 8192 window; the SSM and hybrid archs are returned unchanged,
    as the reference returns them."""
    if cfg.family in ("ssm", "hybrid"):
        return cfg
    if cfg.local_global:
        return cfg.with_(sliding_window=cfg.sliding_window or 4096)
    return cfg.with_(sliding_window=LONG_CONTEXT_WINDOW)


def param_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's shape by dotted path, in leaf order: the
    embedding and head, then the encoder-decoder backbone (``encdec.*``)
    or the decoder stack (``stack.*``) with, for the VLM family, the
    projector (a decoder family the port lacks raises
    ``NotImplementedError``, naming it)."""
    V = padded_vocab(cfg)
    shapes = {"embed.table": (V, cfg.d_model), "head.w": (cfg.d_model, V)}
    if cfg.is_encdec:
        for k, s in encdec_mod.encdec_param_shapes(cfg).items():
            shapes[f"encdec.{k}"] = s
    else:
        for k, s in transformer.stack_param_shapes(cfg).items():
            shapes[f"stack.{k}"] = s
        if cfg.family == "vlm":
            for k, s in multimodal.projector_param_shapes(cfg.d_model, cfg.d_model).items():
                shapes[f"projector.{k}"] = s
    return dict(sorted(shapes.items(), key=lambda kv: kv[0].split(".")))


def _is_router(path: str) -> bool:
    return path.endswith(".moe.router")


# the leaves a block kind keeps in f32, by leaf name
_F32_BY_KIND = {"mamba": ssm_mod.F32_LEAVES, "mlstm": xlstm_mod.MLSTM_F32,
                "slstm": xlstm_mod.SLSTM_F32}
# each recurrent kind's init rules by leaf name (``ssm.leaf_init``)
_INIT_BY_KIND = {"mamba": ssm_mod.leaf_init, "mlstm": xlstm_mod.mlstm_leaf_init,
                 "slstm": xlstm_mod.slstm_leaf_init}


def _stack_kind(cfg: ArchConfig, path: str) -> str | None:
    if not path.startswith("stack."):
        return None
    return transformer.leaf_kind(cfg, path.removeprefix("stack."))


def _leaf_dtype(cfg: ArchConfig, path: str) -> torch.dtype:
    """A leaf's dtype: the config's parameter dtype; f32 for the router
    and for the recurrent blocks' gate and decay leaves."""
    if _is_router(path):
        return moe_mod.ROUTER_DTYPE
    if path.rsplit(".", 1)[-1] in _F32_BY_KIND.get(_stack_kind(cfg, path), ()):
        return torch.float32
    return getattr(torch, cfg.param_dtype)


def _is_routed_expert(path: str) -> bool:
    parts = path.split(".")
    return ("moe" in parts and "shared" not in parts
            and parts[-1] in ("w_gate", "w_up", "w_down"))


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """The parameter count of ``cfg``; ``active_only`` counts each routed
    expert weight at ``k/E`` of its size (the experts a token reaches; ``E``
    the router's width, so a held share counts at its expected load)."""
    total = 0
    for path, shape in param_shapes(cfg).items():
        n = math.prod(shape)
        if active_only and cfg.is_moe and _is_routed_expert(path):
            n = int(n * cfg.experts_per_token / cfg.routed_experts)
        total += n
    return total


def model_flops(cfg: ArchConfig, tokens: int, kind: str = "train") -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    n = count_params(cfg, active_only=True)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


# tensor-parallel specs by leaf name, the reference's rules (the port
# trains data-parallel only; the specs are a plan)
_SHARD_LAST = {"wq", "wk", "wv", "w_gate", "w_up", "wz", "wx", "up_x", "up_z",
               "conv_x", "head_w"}
_SHARD_IN = {"wo", "w_down", "down", "out_proj"}


def _leaf_spec(path: tuple[str, ...], shape: tuple[int, ...], model_axis: int,
               axis_name) -> tuple:
    name, ndim = path[-1], len(shape)

    def spec_with(axis_from_end: int) -> tuple:
        ax = ndim - axis_from_end
        if ax < 0 or shape[ax] % model_axis != 0:
            return ()
        s = [None] * ndim
        s[ax] = axis_name
        return tuple(s)

    if "moe" in path and name in ("w_gate", "w_up", "w_down") and ndim >= 3:
        # expert-parallel on E when divisible, else shard the ff dim (the
        # shared expert's stacked leaves take this rule on their row axis,
        # as in the reference)
        e_ax = ndim - 3
        if shape[e_ax] % model_axis == 0:
            s = [None] * ndim
            s[e_ax] = axis_name
            return tuple(s)
        return spec_with(1) if name in ("w_gate", "w_up") else spec_with(2)
    if name == "table":                      # input embedding: shard d_model
        return spec_with(1)
    if len(path) >= 2 and path[-2] == "head":
        return spec_with(1)                  # vocab-sharded output head
    if name in _SHARD_LAST:
        return spec_with(1)
    if name in _SHARD_IN:
        return spec_with(2)
    return ()


def build_param_specs(cfg: ArchConfig, model_axis: int, axis_name
                      ) -> dict[str, tuple]:
    """Each leaf's tensor-parallel spec by dotted path, in leaf order: a
    tuple with ``axis_name`` at the sharded dimension and ``None``
    elsewhere, or ``()`` for a replicated leaf (a ``PartitionSpec``'s
    entries in the reference's ``build_param_specs``)."""
    return {path: _leaf_spec(tuple(path.split(".")), shape, model_axis, axis_name)
            for path, shape in param_shapes(cfg).items()}


class _Node(nn.Module):
    """A container holding both parameters and sub-containers (``moe``:
    its router and experts beside ``shared``), read by name like the
    ``ParameterDict`` and ``ModuleDict`` that hold only one kind."""

    def __init__(self, leaves: dict[str, nn.Parameter], groups: dict[str, nn.Module]):
        super().__init__()
        for k, p in leaves.items():
            self.register_parameter(k, p)
        for k, m in groups.items():
            self.add_module(k, m)
        self._names = sorted([*leaves, *groups])

    def __getitem__(self, key: str):
        return getattr(self, key)

    def items(self):
        return [(k, self[k]) for k in self._names]


def _nest(flat: dict[str, nn.Parameter]) -> nn.Module:
    """Nested ``ModuleDict``/``ParameterDict`` containers for dotted paths
    (a :class:`_Node` where a level holds both)."""
    groups: dict[str, dict[str, nn.Parameter]] = {}
    leaves: dict[str, nn.Parameter] = {}
    for path, p in flat.items():
        head, _, rest = path.partition(".")
        if rest:
            groups.setdefault(head, {})[rest] = p
        else:
            leaves[head] = p
    if leaves and groups:
        return _Node(leaves, {k: _nest(v) for k, v in groups.items()})
    if leaves:
        return nn.ParameterDict(leaves)
    return nn.ModuleDict({k: _nest(v) for k, v in groups.items()})


def _xent_chunked(head_w, x, labels, cfg):
    """x: (B,S,d) hidden; labels: (B,S), -1 = ignore.  Softmax-xent in
    sequence chunks of ``cfg.xent_chunk`` so the (B,c,V) logits buffer is
    bounded; returns the mean over unmasked labels."""
    B, S, d = x.shape
    c = min(cfg.xent_chunk, S)
    if S % c != 0:
        c = S
    cd = getattr(torch, cfg.compute_dtype)
    w = head_w.to(cd)
    loss_sum = x.new_zeros((), dtype=torch.float32)
    count = x.new_zeros((), dtype=torch.float32)
    for off in range(0, S, c):
        xk, lk = x[:, off:off + c], labels[:, off:off + c]
        logits = softcap((xk.to(cd) @ w).float(), cfg.logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lk.clamp(min=0)[..., None])[..., 0]
        mask = (lk >= 0).float()
        loss_sum = loss_sum + torch.sum((lse - ll) * mask)
        count = count + torch.sum(mask)
    return loss_sum / torch.clamp(count, min=1.0)


def _logits(head_w, x, cfg):
    """(B, S, d) -> f32 logits (B, S, V), with the final-logit softcap."""
    cd = getattr(torch, cfg.compute_dtype)
    return softcap((x.to(cd) @ head_w.to(cd)).float(), cfg.logit_softcap)


class _LM(nn.Module):
    """What both models share: the parameters built from
    :func:`param_shapes` in nested containers, the reference's init rules,
    the leaf order, the token embedding and the cache calls' device."""

    def __init__(self, cfg: ArchConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
        flat = {
            path: nn.Parameter(torch.empty(shape, dtype=_leaf_dtype(cfg, path),
                                           device=dev))
            for path, shape in param_shapes(cfg).items()
        }
        for name, sub in _nest(flat).items():
            self.add_module(name, sub)
        # the embedding's scale sqrt(d_model), rounded to the compute dtype
        # as the reference multiplies by it; built once, on the device
        self.register_buffer("_embed_scale", torch.tensor(
            math.sqrt(cfg.d_model), dtype=getattr(torch, cfg.compute_dtype),
            device=dev), persistent=False)
        self.init_params(seed)

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def named_leaves(self) -> list[tuple[str, nn.Parameter]]:
        """``(path, parameter)`` in the reference's leaf order."""
        return sorted(self.named_parameters(), key=lambda kv: kv[0].split("."))

    @torch.no_grad()
    def init_params(self, seed: int) -> None:
        """Reference init rules (N(0, 0.02) embedding, truncated normal
        matrices (the projector's too), the router's at scale 0.1, zero
        norm scales and biases,
        and the recurrent blocks' own: ``A_log`` 0, ``D`` 1, ``dt_bias``
        0, conv weights N(0, 1) x 0.1 and zero conv biases, ``wdt`` and the
        mLSTM's ``wi``/``wf`` at scale 0.1, the sLSTM's ``r{g}`` at 0.5,
        the forget biases 3), drawn from a seeded ``torch.Generator`` on
        the parameters' device.  Fan-in is the row's ``shape[-2]``."""
        dev = self.device
        gen = None if dev.type == "meta" else torch.Generator(dev).manual_seed(seed)
        for path, p in self.named_leaves():
            kind = _stack_kind(self.cfg, path)
            rule = (_INIT_BY_KIND[kind](path.rsplit(".", 1)[-1])
                    if kind in _INIT_BY_KIND else None)
            if rule is not None:
                how, value = rule
                if how == "const":
                    v = torch.full(p.shape, value, dtype=p.dtype, device=dev)
                elif how == "normal":
                    v = normal_init(p.shape, p.dtype, gen, device=dev, std=value)
                else:
                    v = truncated_normal_init(p.shape, p.dtype, gen, device=dev,
                                              scale=value)
            elif path == "embed.table":
                v = normal_init(p.shape, p.dtype, gen, device=dev, std=0.02)
            elif path.endswith((".scale", ".bq", ".bk", ".bv")):
                v = torch.zeros(p.shape, dtype=p.dtype, device=dev)
            elif _is_router(path):
                v = truncated_normal_init(p.shape, p.dtype, gen, device=dev,
                                          scale=moe_mod.ROUTER_INIT_SCALE)
            else:
                v = truncated_normal_init(p.shape, p.dtype, gen, device=dev)
            p.copy_(v)

    def _tree(self, params):
        """The nested parameter tree the calls read: ``params`` (a tree by
        path, ``core.overlap.install_hooks``'s), or the module's own."""
        if params is not None:
            return params
        return {name: getattr(self, name) for name in self._modules}

    def _embed_tokens(self, tree, tokens):
        """Token embeddings times ``sqrt(d_model)`` in the compute dtype."""
        cd = getattr(torch, self.cfg.compute_dtype)
        x = embed(transformer.resolve(tree["embed"]["table"], cd), tokens, cd)
        return x * self._embed_scale


class DecoderLM(_LM):
    """Decoder-only LM (dense, MoE, SSM, hybrid or VLM): embedding (scaled
    by ``sqrt(d_model)``), for the VLM family the projected patch
    embeddings prepended, the stacked superblock loop, final RMSNorm,
    untied head, chunked xent (with the final-logit softcap)."""

    @property
    def is_vlm(self) -> bool:
        return self.cfg.family == "vlm"

    @property
    def num_stages(self) -> int:
        """The layer loop's stages before the final norm and head: the
        dense prefix's rows and the superblocks (``before_layer``'s last
        index)."""
        return transformer.num_stages(self.cfg)

    def _embed_inputs(self, tree, batch):
        """The token embeddings, with ``patch_embeds`` (VLM, when the batch
        carries them) projected and prepended: (B, P + S, d)."""
        x = self._embed_tokens(tree, batch["tokens"])
        if self.is_vlm and "patch_embeds" in batch:
            cd = getattr(torch, self.cfg.compute_dtype)
            proj = {k: transformer.resolve(v) for k, v in tree["projector"].items()}
            x = torch.cat([multimodal.project(proj, batch["patch_embeds"], cd), x], dim=1)
        return x

    def loss_fn(self, batch: dict[str, torch.Tensor], before_layer=None,
                params: dict | None = None):
        """-> (loss + aux_loss, {"loss", "aux_loss"}), as the reference's
        ``loss_fn`` returns them (``aux_loss``, the MoE blocks' summed
        load-balance loss, is 0 for dense).  For the VLM family a batch
        with ``patch_embeds`` (B, P, d) is trained on the P projected
        patches and the text, its labels padded with -1 over the patches;
        without them it is text only and the projector gets no gradient.
        ``before_layer`` goes to :func:`transformer.stack_train`: it is
        called before each superblock and before the final norm and head.
        ``params`` replaces the module's parameters: a nested dict by path
        (``core.overlap.install_hooks``) whose leaves :mod:`.transformer`
        describes; a deferred leaf is assembled where the forward pass first
        reads it."""
        cfg = self.cfg
        cd = getattr(torch, cfg.compute_dtype)
        tree = self._tree(params)
        x = self._embed_inputs(tree, batch)
        x, aux = transformer.stack_train(tree["stack"], x, cfg, before_layer)
        labels = batch["labels"]
        if self.is_vlm and "patch_embeds" in batch:
            pad = torch.full((labels.shape[0], batch["patch_embeds"].shape[1]), -1,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        loss = _xent_chunked(transformer.resolve(tree["head"]["w"], cd), x, labels, cfg)
        return loss + aux, {"loss": loss, "aux_loss": aux}

    # ---- serving -----------------------------------------------------------
    # ``params`` is ``None`` (the module's own parameters) or the nested
    # tree that ``loss_fn`` takes, so the calls keep the reference's
    # ``(params, ...)`` signatures

    @torch.inference_mode()
    def prefill(self, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Teacher-forced logits of the last ``xent_chunk`` positions,
        (B, <=S, V) f32; a VLM batch's ``patch_embeds`` are prepended."""
        cfg = self.cfg
        tree = self._tree(params)
        x = self._embed_inputs(tree, batch)
        x, _ = transformer.stack_train(tree["stack"], x, cfg)
        c = min(cfg.xent_chunk, x.shape[1])
        return _logits(transformer.resolve(tree["head"]["w"]), x[:, -c:], cfg)

    @torch.inference_mode()
    def decode_step(self, params, caches: dict, batch: dict[str, torch.Tensor]):
        """One token per slot: ``batch = {"tokens": (B, 1), "pos": (B,)}``
        -> ``(logits (B, 1, V) f32, caches)``.  The caches are written in
        place (each slot's row at ``pos``) and returned.  Text only, for the
        VLM family too, as in the reference."""
        tree = self._tree(params)
        x = self._embed_tokens(tree, batch["tokens"])
        x, caches = transformer.stack_decode(tree["stack"], x, caches,
                                             batch["pos"], self.cfg)
        return _logits(transformer.resolve(tree["head"]["w"]), x, self.cfg), caches

    def init_caches(self, batch: int, max_len: int) -> dict:
        """Zero caches for ``batch`` slots of ``max_len`` positions on the
        model's device (``transformer.init_caches``)."""
        return transformer.init_caches(self.cfg, batch, max_len, device=self.device)

    def cache_specs(self, batch: int, max_len: int) -> dict:
        """The caches' shapes and dtypes as ``meta`` tensors."""
        return transformer.init_caches(self.cfg, batch, max_len, device="meta")


class EncDecLM(_LM):
    """Encoder-decoder LM (the audio family): the encoder over the batch's
    ``frames`` (B, T, d), the decoder over the scaled token embeddings with
    cross-attention to the encoder's memory, untied head, chunked xent."""

    @property
    def num_stages(self) -> int:
        """The stages before the final norm and head: the encoder's rows
        ``0 .. E-1``, then ``enc_norm`` with decoder row 0 at ``E``, and
        decoder row ``r`` at ``E + r`` (``core.bucketing.bucket_first_use``)."""
        return self.cfg.encoder_layers + self.cfg.num_layers

    def _forward(self, tree, batch, before_layer=None):
        cfg = self.cfg
        E = cfg.encoder_layers
        # the tokens are embedded before the encoder runs (the reference
        # embeds them after it: the same values), so that the backward
        # pass, which runs the node made last first, reaches the embedding
        # after the encoder, the order ReadyOrder gives its buckets
        x = self._embed_tokens(tree, batch["tokens"])
        memory = encdec_mod.encode(tree["encdec"], batch["frames"], cfg, before_layer)
        # decoder row 0 shares stage E with enc_norm, settled by encode
        dec_hook = None if before_layer is None else (
            lambda r: before_layer(E + r) if r else None)
        return encdec_mod.decode_train(tree["encdec"], x, memory, cfg,
                                       window=cfg.sliding_window, before_layer=dec_hook)

    def loss_fn(self, batch: dict[str, torch.Tensor], before_layer=None,
                params: dict | None = None):
        """-> (loss, {"loss", "aux_loss"}) with ``aux_loss`` 0, as the
        reference's.  The batch carries ``frames`` (B, T, d), ``tokens`` and
        ``labels`` (B, S); without ``frames`` it raises ``KeyError``, as the
        reference's does.  ``before_layer(i)`` is called before each stage
        (:attr:`num_stages`) and, with ``i = num_stages``, before the final
        norm and head; ``params`` as :meth:`DecoderLM.loss_fn` takes it."""
        cfg = self.cfg
        cd = getattr(torch, cfg.compute_dtype)
        tree = self._tree(params)
        x = self._forward(tree, batch, before_layer)
        loss = _xent_chunked(transformer.resolve(tree["head"]["w"], cd), x,
                             batch["labels"], cfg)
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"loss": loss, "aux_loss": aux}

    # ---- serving (``params`` as in DecoderLM) -------------------------------

    @torch.inference_mode()
    def prefill(self, params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Teacher-forced logits of the last ``xent_chunk`` positions of a
        batch with ``frames`` and ``tokens``, (B, <=S, V) f32."""
        tree = self._tree(params)
        x = self._forward(tree, batch)
        c = min(self.cfg.xent_chunk, x.shape[1])
        return _logits(transformer.resolve(tree["head"]["w"]), x[:, -c:], self.cfg)

    @torch.inference_mode()
    def memory_kv(self, params, frames: torch.Tensor):
        """A request's frames (B, T, d) encoded and projected into every
        decoder row's cross-attention keys and values: ``(mem_k, mem_v)``,
        each (L, B, T, K, hd), the caches' leaves of the same names."""
        tree = self._tree(params)
        memory = encdec_mod.encode(tree["encdec"], frames, self.cfg)
        return encdec_mod.precompute_memory_kv(tree["encdec"], memory, self.cfg)

    @torch.inference_mode()
    def decode_step(self, params, caches: dict, batch: dict[str, torch.Tensor]):
        """One token per slot against the caches' ``mem_k``/``mem_v``:
        ``(logits (B, 1, V) f32, caches)``, the self-attention cache
        written in place."""
        tree = self._tree(params)
        x = self._embed_tokens(tree, batch["tokens"])
        x, caches = encdec_mod.decode_step(tree["encdec"], x, caches, batch["pos"],
                                           self.cfg, window=self.cfg.sliding_window)
        return _logits(transformer.resolve(tree["head"]["w"]), x, self.cfg), caches

    def init_caches(self, batch: int, max_len: int) -> dict:
        """Zero caches on the model's device (``encdec.dec_caches``, the
        memory ``frontend_tokens`` long)."""
        return encdec_mod.dec_caches(self.cfg, batch, max_len, self.cfg.frontend_tokens,
                                     window=self.cfg.sliding_window, device=self.device)

    def cache_specs(self, batch: int, max_len: int) -> dict:
        """The caches' shapes and dtypes as ``meta`` tensors."""
        return encdec_mod.dec_caches(self.cfg, batch, max_len, self.cfg.frontend_tokens,
                                     window=self.cfg.sliding_window, device="meta")


def build_model(cfg: ArchConfig, *, device="cuda", seed: int = 0) -> DecoderLM | EncDecLM:
    """:class:`EncDecLM` for an encoder-decoder config, else the
    :class:`DecoderLM` of a dense, MoE, SSM, hybrid or VLM config (another
    family raises ``NotImplementedError`` naming it)."""
    if cfg.is_encdec:
        return EncDecLM(cfg, device=device, seed=seed)
    return DecoderLM(cfg, device=device, seed=seed)
