"""Cell specs: (architecture x input shape) -> abstract step + shardings.

The PyTorch counterpart of ``repro/launch/specs.py``.  ``input_specs``
returns stand-ins for every model input: ``meta`` tensors of the cell's
shapes and dtypes, with no allocation.  ``abstract`` is the counterpart of
``jax.eval_shape``: it builds a state under ``FakeTensorMode`` (the model's
own init, generator and all) and keeps each leaf's shape and dtype as a
``meta`` tensor.  ``make_cell`` packages the step function with the specs
of its arguments (``ShardingRules``'s tuples) for the dry-run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed.sharding import ShardingRules, make_spec
from repro_torch.models import transformer as tx
from repro_torch.models import whisper as wh
from repro_torch.models.common import ModelConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

SHAPES: dict[str, dict[str, Any]] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

# archs with sub-quadratic long-context decode (bounded attention state)
SUBQUADRATIC = {"mamba2-130m", "hymba-1.5b"}


def cell_skip_reason(arch: str, shape: str) -> str | None:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        if arch == "whisper-tiny":
            return "enc-dec decoder ctx is architecturally bounded (448)"
        return "full-attention arch: 512K dense KV decode is quadratic-history"
    return None


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    step_fn: Callable
    args: tuple
    in_shardings: Any
    out_shardings: Any
    donate_argnums: tuple[int, ...]
    meta: dict[str, Any]


def _stand_in(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _to_meta(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    return _stand_in(tree.shape, tree.dtype)


def abstract(fn: Callable[[], Any]) -> Any:
    """The shapes and dtypes of ``fn()``'s tensors as ``meta`` stand-ins,
    with nothing allocated: ``fn`` runs under ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn()
    return _to_meta(out)


def _cell_config(arch: str, shape_name: str, overrides: dict | None = None, *,
                 smoke: bool = False) -> ModelConfig:
    """The cell's config (``smoke``: the arch's smoke config, for tests)."""
    info = SHAPES[shape_name]
    kw: dict[str, Any] = {}
    if info["kind"] == "train":
        # remat + microbatching defaults sized so one sample per device per
        # microbatch at dp=16; hillclimbing tunes these per cell.
        kw["remat"] = "full"
        kw["num_microbatches"] = 8
        kw["logits_chunk"] = 512
        # a single attention chunk at 4k train removes the q/kv chunk double
        # loop, whose per-iteration intermediates dominate the memory term
        kw["attention_chunk"] = 4096
    if arch == "whisper-tiny":
        kw["max_target_len"] = info["seq"] + 8
    cfg = (get_smoke_config if smoke else get_config)(arch, **kw)
    if overrides:
        overrides = {
            k: (getattr(torch, v) if k.endswith("_dtype") and isinstance(v, str)
                else v)
            for k, v in overrides.items()
        }
        cfg = cfg.replace(**overrides)
    return cfg


def input_specs(
    arch: str, shape_name: str, cfg: ModelConfig | None = None
) -> dict[str, torch.Tensor]:
    """Abstract model inputs for one cell (the paper-mandated stand-ins)."""
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]
    cfg = cfg or _cell_config(arch, shape_name)
    specs: dict[str, torch.Tensor] = {}
    if info["kind"] in ("train", "prefill"):
        specs["tokens"] = _stand_in((B, S), torch.int32)
        if cfg.family == "vlm":
            specs["patch_embeds"] = _stand_in((B, cfg.num_image_tokens, cfg.d_model),
                                              torch.float32)
        if cfg.is_encdec:
            specs["frame_embeds"] = _stand_in((B, cfg.encoder_seq, cfg.d_model),
                                              torch.float32)
    else:  # decode
        specs["tokens"] = _stand_in((B, 1), torch.int32)
        specs["positions"] = _stand_in((B, 1), torch.int32)
    return specs


def _batch_sharding(rules: ShardingRules, batch: int, ndim: int) -> tuple:
    dp = math.prod(rules.axes[a] for a in rules.dp_axes)
    first = rules.dp_axes if (batch % dp == 0 and batch >= dp) else None
    return make_spec(first, *([None] * (ndim - 1)))


def cell_meta(arch: str, shape_name: str, cfg: ModelConfig) -> dict[str, Any]:
    info = SHAPES[shape_name]
    counts = cfg.param_counts()
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": info["kind"],
        "batch": info["batch"],
        "seq": info["seq"],
        "params_total": counts["total"],
        "params_active": counts["active"],
    }


def make_cell(
    arch: str,
    shape_name: str,
    rules: ShardingRules,
    overrides: dict | None = None,
    *,
    smoke: bool = False,
) -> Cell:
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]
    kind = info["kind"]
    cfg = _cell_config(arch, shape_name, overrides, smoke=smoke)
    ctx = tx.RunCtx(mesh=rules.mesh, dp_axes=rules.dp_axes, ep_axis="model")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731

    specs = input_specs(arch, shape_name, cfg)
    batch_shardings = {k: _batch_sharding(rules, B, v.ndim) for k, v in specs.items()}
    meta = cell_meta(arch, shape_name, cfg)

    if kind == "train":
        state_shapes = abstract(lambda: init_train_state(cfg, gen()))
        state_sh = rules.state_shardings(state_shapes)
        step = make_train_step(cfg, AdamWConfig(), ctx)
        out_sh = (state_sh, ())  # the metrics replicated
        return Cell(
            arch, shape_name, cfg, step,
            (state_shapes, specs),
            (state_sh, batch_shardings),
            out_sh,
            donate_argnums=(0,),
            meta=meta,
        )

    init = wh.init_params if cfg.is_encdec else tx.init_params
    params_shapes = abstract(lambda: init(cfg, gen()))
    params_sh = rules.state_shardings(params_shapes)

    if cfg.is_encdec:
        cache_shapes = abstract(
            lambda: wh.init_cache(cfg, B, S + 8, cfg.encoder_seq, device="cpu"))
    else:
        cache_shapes = abstract(lambda: tx.init_cache(cfg, B, S + 8, device="cpu"))
    cache_sh = rules.cache_shardings(cache_shapes)
    logits_sh = _batch_sharding(rules, B, 3)

    if kind == "prefill":
        if cfg.is_encdec:
            def step(params, tokens, frames, cache):
                return wh.prefill(cfg, params, tokens, frames, cache, ctx=ctx)

            args = (params_shapes, specs["tokens"], specs["frame_embeds"], cache_shapes)
            in_sh = (
                params_sh, batch_shardings["tokens"],
                batch_shardings["frame_embeds"], cache_sh,
            )
            donate = (3,)
        elif cfg.family == "vlm":
            def step(params, tokens, patch_embeds, cache):
                return tx.prefill(
                    cfg, params, tokens, cache, ctx, patch_embeds=patch_embeds
                )

            args = (params_shapes, specs["tokens"], specs["patch_embeds"], cache_shapes)
            in_sh = (
                params_sh, batch_shardings["tokens"],
                batch_shardings["patch_embeds"], cache_sh,
            )
            donate = (3,)
        else:
            def step(params, tokens, cache):
                return tx.prefill(cfg, params, tokens, cache, ctx)

            args = (params_shapes, specs["tokens"], cache_shapes)
            in_sh = (params_sh, batch_shardings["tokens"], cache_sh)
            donate = (2,)
        out_sh = (logits_sh, cache_sh)
        return Cell(arch, shape_name, cfg, step, args, in_sh, out_sh, donate, meta)

    # decode
    if cfg.is_encdec:
        def step(params, cache, tokens, positions):
            return wh.decode_step(cfg, params, cache, tokens, positions, ctx=ctx)
    else:
        def step(params, cache, tokens, positions):
            return tx.decode_step(cfg, params, cache, tokens, positions, ctx)

    args = (params_shapes, cache_shapes, specs["tokens"], specs["positions"])
    in_sh = (
        params_sh, cache_sh, batch_shardings["tokens"], batch_shardings["positions"]
    )
    out_sh = (logits_sh, cache_sh)
    return Cell(arch, shape_name, cfg, step, args, in_sh, out_sh, (1,), meta)
