"""The frozen work formulas against counts made by hand at one small shape."""

from __future__ import annotations

import torch

from chipbench import weights, work
from conftest import TINY_MODELS

DENSE = {"family": "dense", "num_layers": 1, "d_model": 4, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 2, "d_ff": 8, "vocab_size": 10, "qkv_bias": False,
         "tie_embeddings": True, "sliding_window": 0, "global_layers": []}


def test_pairs_by_hand():
    assert work.causal_pairs(3) == 1 + 2 + 3
    assert work.causal_pairs(5, window=2) == 1 + 2 + 2 + 2 + 2
    assert work.causal_pairs(4, window=9) == 10
    # decode steps at positions 3 and 4 see 4 and 5 keys; with a window of 4, 4 and 4
    assert work.decode_keys(3, 3) == 4 + 5
    assert work.decode_keys(3, 3, window=4) == 4 + 4


def test_request_flops_by_hand():
    # prompt 3, answer 2: 4 tokens through the layer (3 prompt, 1 decode step)
    linear = 4 * 2 * 2 + 2 * 4 * 1 * 2 + 2 * 2 * 4 + 3 * 4 * 8   # q, k + v, o, SwiGLU = 144
    head = 2 * 2 * 4 * 10                                     # LM head at 2 positions
    attn = 4 * 2 * 2 * (6 + 4)                                # 6 prompt pairs, 4 decode keys
    assert work.request_flops(DENSE, 3, 2) == 2 * 4 * linear + head + attn


def test_ssd_flops_by_hand():
    s = {"chunk": 2, "N": 1, "P": 1, "H": 1}
    # chunks of 2, 2 and 1 rows: q(q+1)(N+P) + 4qNP
    assert work.ssd_chunk_flops(5, s) == (2 * 3 * 2 + 8) * 2 + (1 * 2 * 2 + 4)
    model = dict(DENSE, family="hybrid", num_layers=2, global_layers=[0], sliding_window=2,
                 ssm={"d_state": 1, "d_conv": 2, "expand": 1, "head_dim": 2, "chunk": 2})
    s2 = weights.ssm_sizes(model)
    assert s2 == {"din": 4, "H": 2, "P": 2, "N": 1, "K": 2, "chunk": 2, "conv_dim": 6}
    flops, nbytes = work.ssd_prefill_work(model, rows=3, S=5)
    per_chunk = lambda q: q * (q + 1) * (1 + 2) + 4 * q * 1 * 2  # noqa: E731
    assert flops == (per_chunk(2) * 2 + per_chunk(1)) * 2 * 3 * 2
    # x and y (bf16), decay (f32), B and C (bf16), state in and out (f32)
    assert nbytes == (2 * 5 * 2 * 2 * 2 + 5 * 2 * 4 + 2 * 5 * 1 * 2 + 2 * 2 * 2 * 1 * 4) * 3 * 2


def test_attention_roofline_by_hand():
    flops, nbytes = work.attn_prefill_work(DENSE, rows=2, S=3)
    assert flops == 4 * 2 * 2 * 6 * 2
    assert nbytes == (2 * 2 + 2 * 1) * 3 * 2 * 2 * 2
    assert work.least_seconds(flops, nbytes) == max(flops / 989e12, nbytes / 3.35e12)


def test_hybrid_windows_follow_the_layer_groups():
    model = dict(TINY_MODELS["hymba-1.5b"], family="hybrid")
    assert work.layer_windows(model) == [0, 16, 16, 0]
    assert [g[0] for g in weights.layer_groups(model)] == ["global0", "local1", "global1"]


def test_weight_layout_is_the_ports_tree():
    """Leaf for leaf the tree ``init_params`` makes, shapes and all."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer
    from repro_torch.models.common import SSMConfig

    for arch, sizes in TINY_MODELS.items():
        cfg = get_smoke_config(arch)
        if "ssm" in sizes:  # the tiny cell's mixer width, as its file states it
            cfg = cfg.replace(ssm=SSMConfig(**sizes["ssm"]))
        theirs = transformer.init_params(cfg, torch.Generator().manual_seed(0))
        model = {"family": cfg.family, "qkv_bias": False, "tie_embeddings": cfg.tie_embeddings,
                 **sizes}
        mine = weights.make(model, 3, torch.device("cpu"), torch.float32)

        def shapes(tree, prefix=""):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out |= shapes(v, f"{prefix}{k}/")
                else:
                    out[prefix + k] = tuple(v.shape)
            return out

        assert shapes(mine) == shapes(theirs), arch


def test_same_seed_same_weights():
    model = dict(TINY_MODELS["phi4-mini-3.8b"], family="dense", qkv_bias=False,
                 tie_embeddings=True, sliding_window=0, global_layers=[])
    a = weights.make(model, 2**31 + 5, torch.device("cpu"), torch.bfloat16)
    b = weights.make(model, 2**31 + 5, torch.device("cpu"), torch.bfloat16)
    c = weights.make(model, 2**31 + 6, torch.device("cpu"), torch.bfloat16)
    assert torch.equal(a["layers"]["mlp"]["w_up"], b["layers"]["mlp"]["w_up"])
    assert not torch.equal(a["layers"]["mlp"]["w_up"], c["layers"]["mlp"]["w_up"])
    assert a["layers"]["attn"]["w_q"].dtype == torch.bfloat16
