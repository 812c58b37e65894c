"""The frozen work formulas against counts made by hand at one small shape,
and the three cells' counts and weights against the first benchmark's."""

from __future__ import annotations

import hashlib

import pytest
import torch

from chipbench import registry, weights, work
from chipbench.families import dense, hybrid
from conftest import TINY_MODELS, shapes

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
    s2 = hybrid.ssm_sizes(model)
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
    assert [g[0] for g in hybrid.layer_groups(model)] == ["global0", "local1", "global1"]


def _tiny(arch: str) -> dict:
    """A tiny cell's model: the configuration file's, at ``TINY_MODELS``' sizes."""
    return {**registry.config(arch)["model"], **TINY_MODELS[arch]}


def _make(model: dict, seed: int, dtype: torch.dtype) -> dict:
    fam = registry.family(model["family"])
    return weights.make(fam.layout(model), seed, torch.device("cpu"), dtype,
                        getattr(fam, "INITS", None))


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
        mine = _make(_tiny(arch), 3, torch.float32)
        assert shapes(mine) == shapes(theirs), arch


def test_same_seed_same_weights():
    model = dict(TINY_MODELS["phi4-mini-3.8b"], family="dense", qkv_bias=False,
                 tie_embeddings=True, sliding_window=0, global_layers=[])
    a = weights.make(dense.layout(model), 2**31 + 5, torch.device("cpu"), torch.bfloat16)
    b = weights.make(dense.layout(model), 2**31 + 5, torch.device("cpu"), torch.bfloat16)
    c = weights.make(dense.layout(model), 2**31 + 6, torch.device("cpu"), torch.bfloat16)
    assert torch.equal(a["layers"]["mlp"]["w_up"], b["layers"]["mlp"]["w_up"])
    assert not torch.equal(a["layers"]["mlp"]["w_up"], c["layers"]["mlp"]["w_up"])
    assert a["layers"]["attn"]["w_q"].dtype == torch.bfloat16


#: each cell's counts as the first benchmark's ``work`` made them: the FLOPs
#: of one request, and the (FLOPs, bytes) of K1's and K2's prompt work over
#: the traffic's batch
FIRST_COUNTS = {
    "phi4-rag-closed": (14_147_606_544_384, (13_200_581_984_256, 17_179_869_184), (0, 0)),
    "hymba-longdoc-closed": (13_589_303_078_912, (1_288_804_761_600, 754_974_720),
                             (755_813_580_800, 13_803_454_464)),
    "phi4-longctx-closed": (158_545_883_430_912, (105_559_558_717_440, 17_179_869_184),
                            (0, 0)),
}


@pytest.mark.parametrize("cell", sorted(FIRST_COUNTS))
def test_cells_count_the_first_benchmarks_work(cell):
    """The family files count exactly what ``work`` counted before them,
    through the family and through ``work``'s own names."""
    bench = registry.benchmark()
    entry = registry.workload(bench, cell)
    model = registry.config(entry["config"])["model"]
    t = registry.traffic(entry["traffic"])
    flops, attn, ssd = FIRST_COUNTS[cell]
    assert registry.family(model["family"]).request_flops(model, t["prompt_len"],
                                                          t["gen"]) == flops
    assert work.request_flops(model, t["prompt_len"], t["gen"]) == flops
    assert work.attn_prefill_work(model, t["batch"], t["prompt_len"]) == attn
    assert work.ssd_prefill_work(model, t["batch"], t["prompt_len"]) == ssd


def _digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in _tensors(tree):
        h.update(f"{path}{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _tensors(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tensors(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


#: SHA-256 of the tiny cells' weights as the first benchmark's ``weights.make``
#: drew them: every leaf's path, shape, dtype and bytes, in the tree's order
FIRST_WEIGHTS = {
    ("phi4-mini-3.8b", 5, "float32"):
        "1fc47084b24d7e759585771d50970b1fb7eb10567f05397131c7e82e081f14c3",
    ("phi4-mini-3.8b", 5, "bfloat16"):
        "4f14c2e41c5f7ffc283c7fb0a40f01a6db4b590fad716207dcbd4a65b2b9d586",
    ("phi4-mini-3.8b", 2**31 + 7, "float32"):
        "bef0811a2eb1c03e65c18fae8151099ed0936c75c4b2e1ada7e1535861e5a073",
    ("phi4-mini-3.8b", 2**31 + 7, "bfloat16"):
        "db3fe072bbe36cbe266f6fc4175710a111f851b3ae9e999f2ba4975a2dd5f008",
    ("hymba-1.5b", 5, "float32"):
        "178c114709cd568a06148100ca8de99521e19e3b6f970de3c195b558426b76aa",
    ("hymba-1.5b", 5, "bfloat16"):
        "9cc972bccfaf79e4926284dce8a18d47e671dcf753bb537d7a7f66edd1f30ef3",
    ("hymba-1.5b", 2**31 + 7, "float32"):
        "c1d0b265492104bb98a58e77b7ce6244f2acff6c4a87e5a159bc0778dcf18f02",
    ("hymba-1.5b", 2**31 + 7, "bfloat16"):
        "3d8bd070684617f6cce82db579cd692371aa56969fb5deffbd8f8056d7ff6322",
}


@pytest.mark.parametrize("arch,seed,dtype", sorted(FIRST_WEIGHTS))
def test_weights_are_the_first_benchmarks(arch, seed, dtype):
    """The family's layout drawn by ``weights.make`` gives the same bits."""
    got = _make(_tiny(arch), seed, getattr(torch, dtype))
    assert _digest(got) == FIRST_WEIGHTS[arch, seed, dtype]
