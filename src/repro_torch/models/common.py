"""Model configuration shared by all 10 assigned architectures."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard


def shard_hint(x, ctx, dims: tuple) -> Any:
    """Pin ``x``'s layout mid-computation, as the JAX package's
    ``with_sharding_constraint`` does: a ``DTensor`` is redistributed to the
    hint, a plain tensor is returned as it is.

    ``dims`` entries: "dp" (ctx.dp_axes), "tp" (ctx.ep_axis), or None.
    Axes that do not divide the corresponding dim degrade to None, so the
    same model code serves every mesh (and meshless smoke tests).
    """
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = []
    for dim, d in zip(x.shape, dims):
        names: tuple[str, ...] = ()
        if d == "dp":
            names = tuple(ctx.dp_axes)
        elif d == "tp":
            names = (ctx.ep_axis,)
        if names and dim % math.prod(sizes[a] for a in names) != 0:
            names = ()
        spec.append(names)
    out = [Replicate()] * mesh.ndim
    for dim, names in enumerate(spec):
        for name in names:
            out[mesh.mesh_dim_names.index(name)] = Shard(dim)
    return relayout(x, out)


def as_dtensor(x, mesh) -> DTensor:
    """A plain tensor made inside a step, replicated on ``mesh``."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def relayout(x, placements) -> Any:
    """``x`` redistributed to ``placements``: the one place where the port
    redistributes a ``DTensor`` explicitly, at an op for which DTensor has
    no sharding strategy that keeps the layout (an uneven unflatten, an
    in-place write into a sharded cache); GSPMD makes these choices silently
    in the JAX package.  ``unshard``, ``copy_into`` and ``write_rows`` are
    its callers, with ``fsdp_gather``, ``shard_hint`` and ``grad_in_layout``.

    Partial sums bound for a shard are reduce-scattered first, while the
    other mesh dims still split ``x``: DTensor's own order may gather them
    first and reduce the whole (the logits of a decode whose tokens moved,
    partial over ``data`` and split over ``model``)."""
    placements = list(placements)
    if list(x.placements) == placements:
        return x
    first = [t if p.is_partial() and t.is_shard() else p
             for p, t in zip(x.placements, placements)]
    if first != list(x.placements):
        x = x.redistribute(placements=first)
    return x if first == placements else x.redistribute(placements=placements)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient comes back dense.  Used on the local inputs of a
    ``local_map`` body: a transposed local gradient wrapped as a ``DTensor``
    gets a global stride that its local layout does not have, and a view in
    the backward then fails."""
    return _ContiguousGrad.apply(x) if x.requires_grad else x


class _GradInLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return relayout(grad, ctx.placements) if isinstance(grad, DTensor) else grad


def grad_in_layout(x):
    """``x``, whose gradient is laid out as ``x`` before it flows on: the
    backward of a reshape that splits a dim (heads out of a hidden dim)
    cannot take a gradient sharded along that dim when the shards do not
    divide the split.  A plain tensor is returned as it is."""
    return _GradInLayout.apply(x) if isinstance(x, DTensor) and x.requires_grad else x


def unshard(x, dims: tuple[int, ...]) -> Any:
    """``x`` with tensor dims ``dims`` whole on every rank; a plain tensor as
    it is."""
    if not isinstance(x, DTensor):
        return x
    dims = tuple(d % x.ndim for d in dims)
    return relayout(x, [Replicate() if p.is_shard() and p.dim in dims else p
                        for p in x.placements])


def batch_local(fn, *args, rows: int = 1, n_out: int = 1):
    """``fn(*args)`` on each rank's batch rows, through ``local_map``: the
    first ``rows`` arguments keep the dim-0 shards of ``args[0]`` and are
    whole along every other dim, the rest are whole on every rank.  For a
    computation that is independent per batch row and has no DTensor
    strategy over the layout it is given (a grouped convolution with the
    batch over two mesh dims, the SSD scan, a kernel); its ``n_out``
    outputs are batch-sharded as ``args[0]``.  Plain tensors: ``fn`` as it
    is."""
    if not isinstance(args[0], DTensor):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = args[0].device_mesh
    by_row = [p if p.is_shard() and p.dim == 0 else Replicate() for p in args[0].placements]
    whole = [Replicate()] * mesh.ndim
    laid, in_pl = [], []
    for i, t in enumerate(args):
        if not isinstance(t, torch.Tensor):
            laid.append(t)
            in_pl.append(None)
            continue
        pl = by_row if i < rows else whole
        laid.append(relayout(as_dtensor(t, mesh), pl))
        in_pl.append(pl)
    out_pl = by_row if n_out == 1 else tuple([by_row] * n_out)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl))(*laid)


# A layer whose tokens move meets its params in their FSDP shards: its
# tokens are gathered over the data axes once, each product's partial sums
# reduce back, and a few products move their outputs.  Moving the tokens
# pays when gathering the params would move more than this many times the
# bytes of the tokens whole over the data axes.  In the dry-run's
# production cells the decisions are far from the line: a decode layer's
# params gather to 5.5-296x this many token bytes, and a prefill's or
# train microbatch's tokens are 3.5-1481x the layer's gathered params.
TOKEN_MOVES = 8


def _fsdp_axes(tree, ctx) -> set[str]:
    """The data-parallel axes that shard some leaf of ``tree``."""
    if isinstance(tree, dict):
        return set().union(*(_fsdp_axes(v, ctx) for v in tree.values()))
    if not isinstance(tree, DTensor):
        return set()
    names = tree.device_mesh.mesh_dim_names
    return {names[i] for i, p in enumerate(tree.placements)
            if p.is_shard() and names[i] in ctx.dp_axes}


def _dp_gathered_bytes(tree, ctx) -> int:
    """The bytes ``fsdp_gather(tree, ctx)`` would gather: each leaf sharded
    over a data axis, whole over those axes (still split over the others)."""
    if isinstance(tree, dict):
        return sum(_dp_gathered_bytes(v, ctx) for v in tree.values())
    if not isinstance(tree, DTensor):
        return 0
    mesh = tree.device_mesh
    n = math.prod(mesh.size(i) for i, p in enumerate(tree.placements)
                  if p.is_shard() and mesh.mesh_dim_names[i] in ctx.dp_axes)
    if n == 1:
        return 0
    local = tree.to_local()
    return n * local.numel() * local.element_size()


def moves_tokens(tree, ctx, token_bytes: int) -> bool:
    """True when ``tree``'s params should stay in their FSDP shards and the
    ``token_bytes`` of activations (whole over the data axes) that meet them
    move instead: what a decode step does, as GSPMD lays out the JAX
    package's (see ``TOKEN_MOVES``)."""
    if not isinstance(getattr(ctx, "mesh", None), DeviceMesh):
        return False  # one device: nothing is sharded
    return 0 < TOKEN_MOVES * token_bytes < _dp_gathered_bytes(tree, ctx)


def fsdp_gather(tree, ctx) -> Any:
    """A layer's (or the embedding's) params whole over the data-parallel
    axes, still sharded over the others: ZeRO-3's all-gather at use, one
    layer at a time (under remat it runs again in the backward, whose
    gradient reduce-scatters back to the FSDP shards).  Its callers skip it
    where ``moves_tokens``.  Plain tensors are returned as they are."""
    if isinstance(tree, dict):
        return {k: fsdp_gather(v, ctx) for k, v in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    names = tree.device_mesh.mesh_dim_names
    return relayout(tree, [Replicate() if names[i] in ctx.dp_axes else p
                           for i, p in enumerate(tree.placements)])


def tokens_whole(x, ctx, params) -> Any:
    """``x`` whole over the data-parallel axes that shard ``params`` (an
    all-gather of the tokens), still laid out as it was over the others; a
    plain tensor as it is.  The products of a layer whose params stay in
    their FSDP shards then take the rank's slice of the tokens' hidden dim
    and leave partial sums over those axes; a data axis that only
    replicates the params (``pod`` without ``fsdp_pod``) keeps its tokens."""
    if not isinstance(x, DTensor):
        return x
    axes = _fsdp_axes(params, ctx)
    names = x.device_mesh.mesh_dim_names
    return relayout(x, [Replicate() if names[i] in axes else p
                        for i, p in enumerate(x.placements)])


def nbytes(x) -> int:
    """The bytes of ``x`` whole (a ``DTensor``'s global size)."""
    return x.numel() * x.element_size()


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, with ``src`` laid out as ``dst`` first when ``dst``
    is a ``DTensor`` (an in-place op cannot change its target's layout)."""
    if isinstance(dst, DTensor):
        src = relayout(as_dtensor(src, dst.device_mesh), dst.placements)
    dst.copy_(src)


def write_rows(buf: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """``buf[b, pos[b, j]] = new[b, j]`` in place: the slot writes of the
    caches, ``buf`` (B, S, ...), ``pos`` (B, S_new) slots that run on by one
    modulo S from ``pos[:, 0]``, ``new`` (B, S_new, ...).

    On a ``DTensor`` cache each rank writes its own shard: ``pos`` and
    ``new`` are laid out on the cache's batch and trailing shards (whole
    along the slots), and where the slot dim itself is sharded (a
    context-parallel cache) each local slot takes the value written to it,
    if any, as a gather (a scatter would need data-dependent shapes)."""
    if not isinstance(buf, DTensor):
        bidx = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[bidx, pos] = new
        return
    mesh = buf.device_mesh
    on_batch = [p if p.is_shard() and p.dim == 0 else Replicate() for p in buf.placements]
    on_rest = [p if p.is_shard() and p.dim != 1 else Replicate() for p in buf.placements]
    pos_l = relayout(as_dtensor(pos, mesh), on_batch).to_local()
    new_l = relayout(as_dtensor(new, mesh), on_rest).to_local()
    buf_l = buf.to_local()
    bidx = torch.arange(buf_l.shape[0], device=buf_l.device)[:, None]
    slot_dims = [i for i, p in enumerate(buf.placements) if p.is_shard() and p.dim == 1]
    if not slot_dims:
        buf_l[bidx, pos_l] = new_l
        return
    coord = mesh.get_coordinate()
    shard = 0
    for i in slot_dims:
        shard = shard * mesh.size(i) + coord[i]
    n_loc, n_new = buf_l.shape[1], pos_l.shape[1]
    slots = shard * n_loc + torch.arange(n_loc, device=buf_l.device)
    j = (slots[None, :] - pos_l[:, :1]) % buf.shape[1]        # (B_loc, n_loc)
    keep = (j < n_new).reshape(*j.shape, *([1] * (buf_l.ndim - 2)))
    buf_l.copy_(torch.where(keep, new_l[bidx, j.clamp(max=n_new - 1)], buf_l))


def last_masked(nll: torch.Tensor) -> torch.Tensor:
    """The loss mask of a (B, S) per-token loss: 1, and 0 at the last
    position.  Built from the positions rather than written in place, so a
    batch-sharded ``DTensor`` loss takes it as it is."""
    S = nll.shape[1]
    keep = torch.arange(S, device=nll.device) < S - 1
    return keep.to(nll.dtype).expand(nll.shape)


@dataclass
class MoEConfig:
    num_experts: int = 0           # routed experts
    top_k: int = 0
    num_shared: int = 0            # shared (always-on) experts
    expert_d_ff: int = 0           # per-expert hidden
    first_dense: int = 0           # leading dense layers before MoE starts
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # the port's own options; the defaults give the JAX package's maths
    norm_topk_prob: bool = True    # False: the chosen router probabilities as they are
    dense_d_ff: int = 0            # leading dense layers' hidden; 0: (top_k + shared) * expert_d_ff


@dataclass
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    q_lora_rank: int = 0  # 0 = full-rank q projection (V2-Lite)
    # the port's own option (off: the JAX package's maths): RMSNorm of the
    # latent c with a learned scale (DeepSeek-V2's kv_a_layernorm)
    latent_norm: bool = False


@dataclass(frozen=True)
class YarnConfig:
    """YaRN's scaling of the rotary frequencies (DeepSeek-V2's
    ``rope_scaling`` of type "yarn"); ``layers.yarn_inv_freq`` and
    ``layers.yarn_mscale`` compute from it."""

    factor: float = 1.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass
class ModelConfig:
    name: str
    # dense | moe | ssm | hybrid | audio | vlm; a config with ``moe`` stacks
    # MoE layers whatever its family is named (deepseek_v2 in the benchmark)
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    mlp: str = "swiglu"            # swiglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    max_seq_len: int = 1 << 20

    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    mla: MLAConfig | None = None
    # the port's own option (None: the JAX package's plain RoPE): YaRN on
    # MLA's rotary dims and in its softmax scale
    yarn: YarnConfig | None = None

    # hybrid (hymba): sliding window for local attention layers; indices of
    # layers using global (full) attention
    sliding_window: int = 0        # 0 = full attention everywhere
    global_layers: tuple[int, ...] = ()

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500        # fixed 30s audio frames
    max_target_len: int = 448

    # vlm: number of leading positions replaced by patch embeddings
    num_image_tokens: int = 0

    # numerics / execution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # "pallas" keeps the JAX package's name: here it selects the hand-written
    # CUDA flash-attention kernel (the plain version on CPU tensors)
    attention_impl: str = "reference"   # reference | pallas
    attention_chunk: int = 1024         # KV chunk for online-softmax reference
    # serving: all requests in a decode batch write the same cache slot
    # (aligned continuous batching): one contiguous slice write per step
    # instead of a ragged per-row scatter.
    aligned_decode: bool = False
    # scan_layers: kept for config parity; the port loops over the stacked
    # layer dim either way.
    scan_layers: bool = True
    moe_impl: str = "ep"                # ep (shard_map all-to-all) | dense
    remat: str = "none"                 # none | dots | full
    num_microbatches: int = 1
    logits_chunk: int = 0               # 0 = single logits matmul

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            self.head_dim = self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for MODEL_FLOPS = 6·N·D roofline term) ----------

    def param_counts(self) -> dict[str, int]:
        """Analytic parameter counts: total and active-per-token."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim

        embed = V * d if self.tie_embeddings else 2 * V * d

        if self.mla is not None:
            m = self.mla
            q_dim = H * (m.qk_nope_dim + m.qk_rope_dim)
            attn = (
                d * q_dim                                   # q proj
                + d * (m.kv_lora_rank + m.qk_rope_dim)      # kv down
                + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)  # kv up
                + H * m.v_head_dim * d                      # o proj
            )
        else:
            attn = d * H * hd + 2 * d * KV * hd + H * hd * d

        mlp_mult = 3 if self.mlp == "swiglu" else 2
        dense_mlp = mlp_mult * d * f

        ssm = 0
        if self.ssm is not None:
            s = self.ssm
            din = s.d_inner(d)
            nh = s.n_heads(d)
            ssm = (
                d * (2 * din + 2 * s.d_state + nh)  # in_proj (x,z,B,C,dt)
                + din * s.d_conv                     # conv
                + din * d                            # out_proj
                + 2 * nh                             # A, D
            )

        per_layer_total = per_layer_active = 0
        n_moe_layers = 0
        if self.moe is not None:
            mo = self.moe
            expert = mlp_mult * d * mo.expert_d_ff
            router = d * mo.num_experts
            moe_total = mo.num_experts * expert + mo.num_shared * expert + router
            moe_active = mo.top_k * expert + mo.num_shared * expert + router
            n_moe_layers = self.num_layers - mo.first_dense
            per_layer_total = attn + moe_total
            per_layer_active = attn + moe_active
            dense_layers = mo.first_dense
        else:
            dense_layers = self.num_layers

        if self.family == "ssm":
            layer = ssm
        elif self.family == "hybrid":
            layer = attn + ssm + dense_mlp
        else:
            layer = attn + dense_mlp

        total = embed + dense_layers * layer + n_moe_layers * per_layer_total
        active = embed + dense_layers * layer + n_moe_layers * per_layer_active
        if self.is_encdec:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = self.encoder_layers * (attn + dense_mlp)
            dec = self.num_layers * (2 * attn + dense_mlp)
            total = embed + enc + dec
            active = total
        return {"total": total, "active": active}
