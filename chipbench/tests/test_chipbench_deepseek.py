"""DeepSeek-V2-Lite's configuration and cell: the file states the published
model, the ``deepseek_v2`` family's layout is the port's tree with the
published options on, its counts are the hand counts, and its reference
gives the logits of the tests' own plain forward
(``tests/plain_deepseek_v2.py``)."""

from __future__ import annotations

import json
import sys

import torch
from repro_torch.configs import get_config
from repro_torch.models import transformer

from chipbench import registry, run, weights
from chipbench.work import causal_pairs
from conftest import REPO, published_gaps, shapes

sys.path.insert(0, str(REPO / "tests"))
import plain_deepseek_v2  # noqa: E402

CONFIG, CELL = "deepseek-v2-lite", "dsv2lite-summary-closed"
#: the source's config.json (https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite), the
#: keys that say something of the model's shape
SOURCE = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy",
    "v_head_dim": 128, "vocab_size": 102400,
}
#: small sizes for the CPU, every published option kept as the file states it
SMALL = {"num_layers": 3, "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "head_dim": 16,
         "d_ff": 64, "vocab_size": 256}
SMALL_MLA = {"kv_lora_rank": 32, "qk_rope_dim": 8, "qk_nope_dim": 16, "v_head_dim": 16}
SMALL_MOE = {"num_experts": 8, "top_k": 2, "num_shared": 1, "expert_d_ff": 64,
             "dense_d_ff": 96}


def _small_spec() -> dict:
    spec = registry.config(CONFIG)
    model = spec["model"]
    model.update(SMALL)
    model["mla"].update(SMALL_MLA)
    model["moe"].update(SMALL_MOE)
    spec["param_dtype"] = spec["compute_dtype"] = "float32"
    return spec


def test_the_file_states_the_published_model():
    spec = registry.config(CONFIG)
    entry = [c for c in registry.benchmark()["configs"] if c["name"] == CONFIG][0]
    assert {k: spec[k] for k in SOURCE} == SOURCE
    assert spec["published"] == {k: SOURCE[k] for k in spec["published"]}
    assert set(SOURCE) - set(spec["published"]) == {"max_position_embeddings", "model_type",
                                                    "seq_aux"}
    assert entry["reduced"] == spec["reduced"] == [] and spec["port_arch"] == "deepseek-v2-lite-16b"
    assert published_gaps(REPO / "chipbench", entry) == {}
    cfg = run.port_config(get_config, spec)
    assert cfg.mla.latent_norm and not cfg.moe.norm_topk_prob and cfg.yarn.factor == 40
    assert cfg.moe.dense_d_ff == 10944 and cfg.attention_impl == "pallas"
    assert len(spec["departures"]) == 1 and "permutation" in spec["departures"][0]


def test_the_cell_is_one_chip_of_published_summaries():
    bench = registry.benchmark()
    cell = registry.workload(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "summary-closed", 1)
    t = registry.traffic("summary-closed")
    assert (t["loop"], t["batch"], t["clients"], t["prompt_len"], t["gen"], t["max_wait_ms"]) == (
        "closed", 32, 64, 4096, 64, 50)
    mine = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
            if CELL in m.get("workloads", [CELL])}
    assert mine == {"output_tok_s", "peak_mem_gb", "setup_s", "prefill_device_ms",
                    "decode_step_ms", "mfu", "device_idle_share", "decode_launches_per_step",
                    "decode_cpu_share", "decode_graph_share", "mla_prefill_roofline",
                    "moe_prefill_roofline"}


def test_the_layout_is_the_ports_tree_with_every_option_on():
    spec = _small_spec()
    fam = registry.family("deepseek_v2")
    mine = weights.make(fam.layout(spec["model"]), 7, torch.device("cpu"), torch.float32)
    cfg = run.port_config(get_config, spec)
    assert cfg.mla.latent_norm and cfg.moe.dense_d_ff == 96
    theirs = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    assert list(shapes(mine).items()) == list(shapes(theirs).items())
    assert shapes(mine)["moe/attn/kv_norm/scale"] == (2, 32)
    assert shapes(mine)["dense0/mlp/w_gate"] == (1, 64, 96)


def test_the_counts_are_the_hand_counts():
    model = _small_spec()["model"]
    fam = registry.family("deepseek_v2")
    S, G = 10, 4
    # per layer: attention weights d H (nope + rope) + d (r + rope) + H v d + r H (nope + v)
    attn = 64 * 4 * 24 + 64 * 40 + 4 * 16 * 64 + 32 * 4 * 32
    dense_mlp, moe_mlp = 3 * 64 * 96, 3 * 3 * 64 * 64 + 64 * 8      # top 2 + 1 shared, router
    pairs = 2 * 4 * (16 + 8 + 16) * causal_pairs(S)                  # 55 pairs
    keys = 2 * 4 * (2 * 32 + 8) * (11 + 12 + 13)                     # G - 1 steps' keys
    tokens = S + G - 1
    want = (2 * G * 64 * 256 + 2 * tokens * (attn + dense_mlp) + pairs + keys
            + 2 * (2 * tokens * (attn + moe_mlp) + pairs + keys))
    assert fam.request_flops(model, S, G) == want == 3986752
    # two rows, three MLA layers: the up-projections and 2 H (qk + v) a pair; c, the rope
    # key, q, v and the output once a row, the up-projections' weights once
    flops = 3 * 2 * (2 * S * 32 * 4 * (16 + 16) + 2 * 4 * 40 * 55)
    nbytes = 3 * (2 * S * (32 + 8 + 4 * 24 + 4 * 16) * 2 + 32 * 4 * 32 * 2)
    assert fam.mla_prefill_work(model, 2, S) == (flops, nbytes) == (597120, 48576)
    # two MoE layers: 2 rows x S tokens x (2 routed + 1 shared) SwiGLUs; 8 + 1 experts once
    flops = 2 * (2 * 2 * S * 3 * 3 * 64 * 64)
    nbytes = 2 * (9 * 3 * 64 * 64 * 2)
    assert fam.moe_prefill_work(model, 2, S) == (flops, nbytes) == (2949120, 442368)


def test_the_reference_is_the_tests_plain_forward():
    spec = _small_spec()
    model = spec["model"]
    params = weights.make(registry.family("deepseek_v2").layout(model), 3, torch.device("cpu"),
                          torch.float32)
    gen = torch.Generator().manual_seed(4)
    for group in ("dense0", "moe"):
        norm = params[group]["attn"]["kv_norm"]["scale"]
        norm.copy_(1 + 0.5 * torch.rand(norm.shape, generator=gen))
    tokens = torch.randint(0, model["vocab_size"], (2, 21), generator=gen)
    positions = [3, 11, 20]
    ref = registry.reference(spec["reference"])
    got = ref.logits(model, params, tokens, positions)
    want = plain_deepseek_v2.forward(model, params, tokens)[:, positions]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    low = ref.logits(model, params, tokens, positions, "fp8")
    assert (low - want).abs().max() > 1e-3      # the control is another precision


def test_a_tiny_copy_of_the_cell_runs_correct(bench_copy):
    """The cell's configuration with every option on at small sizes, its
    weights in bfloat16, its traffic cut to a tiny closed loop, through
    ``run_cell`` traced: correct, and the new metrics left out where the CPU
    has no device time.  Compute is float32: in bfloat16 this tiny model
    serves a token 0.31 below the reference's best once in some fifty
    requests (with either attention impl; float32 reads 0 over a hundred),
    so how many requests a window finishes on the host would decide the
    reading."""
    spec = _small_spec()
    spec["name"] = "tiny-dsv2"
    spec["param_dtype"] = "bfloat16"
    (bench_copy / "configs" / "tiny-dsv2.json").write_text(json.dumps(spec))
    (bench_copy / "traffic" / "tiny.json").write_text(json.dumps(
        {"loop": "closed", "batch": 2, "clients": 4, "prompt_len": 40, "gen": 6,
         "max_wait_ms": 20}))
    (bench_copy / "checks" / "tiny-dsv2-cell.json").write_text(json.dumps(
        {"sample_requests": 64, "limits": {"logit_gap": 0.1}}))
    bench_file = bench_copy.parent / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    bench["workloads"].append({"name": "tiny-dsv2-cell", "config": "tiny-dsv2",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-dsv2-cell")
    bench_file.write_text(json.dumps(bench))
    out = run.run_cell("tiny-dsv2-cell", 2**31 + 5, 1.0, True, torch.device("cpu"),
                       root=bench_copy)
    assert out["correct"], out["check"]
    assert "mfu" in out["metrics"]
    assert not {"mla_prefill_roofline", "moe_prefill_roofline"} & set(out["metrics"])
