"""The port's configs equal the JAX package's, field for field.

Dtypes are compared by name (``jnp.float32`` against ``torch.float32``);
every other field, nested MoE/SSM/MLA configs included, must be equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro_torch import configs as torch_configs
from repro_torch.models.common import ModelConfig

torch.set_num_threads(1)

ARCHS = jax_configs.list_archs()


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            v = _dtype_name(v)
        elif dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        out[f.name] = v
    return out


def test_registry_lists_the_same_archs():
    assert torch_configs.list_archs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["full", "smoke"])
def test_config_matches_jax(arch, kind):
    get_j = jax_configs.get_config if kind == "full" else jax_configs.get_smoke_config
    get_t = torch_configs.get_config if kind == "full" else torch_configs.get_smoke_config
    jcfg, tcfg = get_j(arch), get_t(arch)
    assert isinstance(tcfg, ModelConfig)
    assert isinstance(tcfg.param_dtype, torch.dtype)
    assert isinstance(tcfg.compute_dtype, torch.dtype)
    assert _fields(tcfg) == _fields(jcfg)
    assert tcfg.param_counts() == jcfg.param_counts()


def test_overrides_and_unknown_arch():
    cfg = torch_configs.get_config("qwen2.5-3b", attention_impl="pallas", num_layers=3)
    assert cfg.attention_impl == "pallas" and cfg.num_layers == 3
    assert torch_configs.get_config("qwen2.5-3b").attention_impl == "reference"
    with pytest.raises(KeyError, match="unknown arch"):
        torch_configs.get_config("gpt-5")


def test_qwen_full_width_is_the_serving_model():
    cfg = torch_configs.get_config("qwen2.5-3b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads) == (36, 2048, 16, 2)
    assert (cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (128, 11008, 151_936)
    assert cfg.qkv_bias and cfg.tie_embeddings
    assert cfg.compute_dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    assert 3.0e9 < cfg.param_counts()["total"] < 3.2e9
