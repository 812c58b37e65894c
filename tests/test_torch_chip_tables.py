"""``chip_smoke.py``'s tables against the configs they stand for.

The card run holds every serve path to ``SERVE_LAUNCHES`` exactly and times
K1 at the ``FA_*`` prefill shapes, so a table that drifts from its config
would hold the card to the wrong count or time a shape no model runs.  Here,
on the CPU: a dense arch's K1 launches a prefill are its layer count (every
layer's prompt attention), each model's prefill shape is (serving batch 4,
its heads, its K/V heads, the 1024-token prompt, its head dim, causal), the
dense archs' serve arguments and config cuts, and the ``kernels`` line's
sums over the serve paths.
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.serve import parse_args

torch.set_num_threads(1)

DENSE = ["qwen2.5-3b", *chip_smoke.DENSE_ARCHS]
PREFILLS = {
    "phi4-mini-3.8b": chip_smoke.FA_PHI4,
    "internvl2-2b": chip_smoke.FA_INTERNVL2,
    "starcoder2-15b": chip_smoke.FA_STARCODER2,
    "granite-20b": chip_smoke.FA_GRANITE,
    "kimi-k2-1t-a32b": chip_smoke.FA_KIMI,
}


def test_the_new_dense_archs_are_the_four_of_this_slice():
    assert chip_smoke.DENSE_ARCHS == ("phi4-mini-3.8b", "internvl2-2b", "starcoder2-15b",
                                      "granite-20b")


@pytest.mark.parametrize("arch", DENSE)
def test_dense_serve_launches_flash_once_a_layer(arch):
    cfg = chip_smoke.cut_config(arch)
    assert chip_smoke.SERVE_LAUNCHES[arch] == {"flash_attention": cfg.num_layers}
    assert cfg.num_layers == get_config(arch).num_layers  # no layer is cut


@pytest.mark.parametrize("arch", list(PREFILLS))
def test_prefill_shape_is_the_models(arch):
    cfg = get_config(arch)
    shape = PREFILLS[arch]
    assert shape == (4, cfg.num_heads, cfg.num_kv_heads, 1024, 1024, cfg.head_dim, True)
    assert shape in chip_smoke.FA_BF16_EDGES and shape in chip_smoke.FA_PREFILLS


def test_deepseek_serve_launches_flash_once_a_layer():
    """Every layer of deepseek-v2-lite is MLA, whose serving prefill runs K1."""
    cfg = chip_smoke.cut_config("deepseek-v2-lite-16b")
    assert cfg.mla is not None and cfg.num_layers == 27
    assert chip_smoke.SERVE_LAUNCHES["deepseek-v2-lite-16b"] == {"flash_attention": 27}


def test_mla_prefill_shape_is_deepseek_v2_lites():
    """``FA_MLA`` is the published DeepSeek-V2-Lite's MLA prefill as
    ``attention._mla_flash`` hands it to K1, at serving batch 4 and a
    1024-token prompt: every head its own K/V head, q . k at nope + rope,
    v at its own width, YaRN's softmax scale, and the wrapper's pad to the
    hd-256 instance."""
    import json

    from repro_torch.kernels.flash_attention.kernel import kernel_route
    from repro_torch.models import attention
    from repro_torch.models.common import MLAConfig, YarnConfig

    spec = json.loads((chip_smoke.ROOT / "chipbench" / "configs" /
                       "deepseek-v2-lite.json").read_text())
    model = spec["model"]
    cfg = get_config("deepseek-v2-lite-16b").replace(mla=MLAConfig(**model["mla"]),
                                                     yarn=YarnConfig(**model["yarn"]))
    B, H, KV, S, hd, dv, scale = chip_smoke.FA_MLA
    assert (B, S) == (4, 1024)
    assert H == KV == model["num_heads"] == spec["num_attention_heads"]
    assert hd == spec["qk_nope_head_dim"] + spec["qk_rope_head_dim"] == 192
    assert dv == spec["v_head_dim"] == 128
    assert scale == pytest.approx(attention.mla_scale(cfg), rel=1e-12)
    assert scale == pytest.approx(0.1147214, abs=1e-7)
    assert kernel_route(hd, torch.bfloat16)[1:] == (256, True)


@pytest.mark.parametrize("arch", chip_smoke.DENSE_ARCHS)
def test_dense_serve_args_are_the_serving_cell(arch):
    args = parse_args(chip_smoke.DENSE_SERVE_ARGS[arch])
    assert (args.arch, args.batch, args.prompt_len, args.gen, args.requests, args.device) == (
        arch, 4, 1024, 32, 8, "cuda")
    assert not args.smoke


def test_config_cuts_keep_full_depth_but_kimi():
    for arch, cut in chip_smoke.CONFIG_CUTS.items():
        assert cut.get("param_dtype") == torch.bfloat16, arch
        assert set(cut) == ({"num_layers", "param_dtype"} if arch == "kimi-k2-1t-a32b"
                            else {"param_dtype"}), arch
    assert "phi4-mini-3.8b" not in chip_smoke.CONFIG_CUTS  # f32 params fit
    assert "internvl2-2b" not in chip_smoke.CONFIG_CUTS


def test_kernels_line_sums_the_serve_paths():
    """8 requests in batches of 4: two prefills on every serve path."""
    served = [argv[argv.index("--arch") + 1] for argv in (
        chip_smoke.SERVE_ARGS, chip_smoke.MAMBA_SERVE_ARGS, chip_smoke.HYMBA_SERVE_ARGS,
        chip_smoke.KIMI_SERVE_ARGS, chip_smoke.DEEPSEEK_SERVE_ARGS,
        *chip_smoke.DENSE_SERVE_ARGS.values())] + ["whisper-tiny"]
    assert sorted(served) == sorted(chip_smoke.SERVE_LAUNCHES)
    total = {k: 2 * sum(chip_smoke.SERVE_LAUNCHES[a].get(k, 0) for a in served)
             for k in ("flash_attention", "ssd_scan")}
    # hymba's 29 windowed layers take K1 since its window: 2 x 29 more than 448
    assert total == {"flash_attention": 506, "ssd_scan": 112}


def test_hymba_serve_launches_flash_in_every_layer():
    """hymba's three global layers and its windowed ones all run K1 in a
    prefill; every layer's mixer runs K2."""
    cfg = get_config("hymba-1.5b")
    assert cfg.sliding_window > 0 and len(cfg.global_layers) == 3
    assert chip_smoke.SERVE_LAUNCHES["hymba-1.5b"] == {"flash_attention": cfg.num_layers,
                                                       "ssd_scan": cfg.num_layers}


def test_window_shapes_are_hymbas_cell_and_the_kernels_edges():
    """``FA_WINDOW`` is hymba-1.5b's windowed prefill as its benchmark cell
    runs it (``hymba-longdoc-closed``: batch 8, prompts four times the
    window); the window's other cases stay inside the wrapper's contract,
    and its edge windows lie at and below the kernel's 128-key tile."""
    import json

    from repro_torch.kernels.flash_attention.kernel import kernel_route

    cfg = get_config("hymba-1.5b")
    cell = json.loads((chip_smoke.ROOT / "chipbench" / "traffic" /
                       "longdoc-closed.json").read_text())
    B, H, KV, S, hd, window = chip_smoke.FA_WINDOW
    assert (H, KV, hd, window) == (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                   cfg.sliding_window)
    assert (B, S) == (cell["batch"], cell["prompt_len"]) and S == 4 * window
    kernels = set()
    for (B, H, KV, S, hd, window), dtype in chip_smoke.FA_WINDOW_CONTRACT.values():
        assert H % KV == 0 and 0 < window < S
        kernels.add(kernel_route(hd, dtype)[0])
    assert kernels == {"fa_fwd_tc<f16>", "fa_fwd_f32", "fa_fwd_wide<bf16>"}
    assert any(w <= 128 for *_, w in chip_smoke.FA_WINDOW_EDGES)
    assert all(S % 128 and 0 < w < S for (_, _, _, S, _, w) in chip_smoke.FA_WINDOW_EDGES)
    assert chip_smoke.WINDOW_FAULTS == ("window ignored", "last kv tile skipped")


def test_every_decoder_only_arch_is_trained_card_against_cpu():
    """Phase 4c: mamba2-130m by its own step, the other eight here."""
    decoders = {a for a in list_archs() if not get_config(a).is_encdec} - {"mamba2-130m"}
    assert set(chip_smoke.TRAIN_CHECK_ARCHS) == decoders


@pytest.mark.parametrize("name", list(chip_smoke.FA_CONTRACT))
def test_flash_contract_cases_take_the_instance_they_name(name):
    """Each K1 contract case runs a head dim and dtype the CUDA wrapper
    takes: an instance of its own at 80, 96 and 256, the f16 instance at
    qwen2.5-3b's shape, the pad to 128 at qwen's heads for 112, and the
    wide kernel at Gemma-2-2B's heads past 256."""
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, kernel_route

    (B, H, KV, S, hd), dtype = chip_smoke.FA_CONTRACT[name]
    kernel, width, padded = kernel_route(hd, dtype)
    wide = hd > HEAD_DIMS[-1]
    assert (B, S) == (4, 1024) and H % KV == 0 and (width in HEAD_DIMS or wide)
    assert padded == ("padded" in name) and (width == 128 if padded else width == hd)
    assert kernel.startswith("fa_fwd_wide") == wide
    assert (kernel in ("fa_fwd_f32", "fa_fwd_wide<f32>")) == (dtype == torch.float32)
    if wide:
        gemma = chip_smoke.FA_CONTRACT["gemma-2-2b hd 256"][0]
        assert (B, H, KV, S) == gemma[:4] and name.endswith(str(dtype).split(".")[-1])
    qwen = get_config("qwen2.5-3b")
    if "qwen" in name:
        assert (H, KV) == (qwen.num_heads, qwen.num_kv_heads)
        assert hd == (112 if padded else qwen.head_dim)


@pytest.mark.parametrize("name", list(chip_smoke.SSD_CONTRACT))
def test_ssd_contract_cases_are_mamba2s_prefill_past_the_old_limits(name):
    """Each K2 contract case is mamba2-130m's serving prefill (batch 4,
    1024 steps, its heads and head dim) at a chunk or state width over 128
    or in float16, inside the launcher's contract."""
    from repro_torch.kernels.ssd_scan.kernel import check_contract

    (B, S, H, P, N), chunk, dtype = chip_smoke.SSD_CONTRACT[name]
    cfg = get_config("mamba2-130m")
    assert (B, S, H, P) == (4, 1024, cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim)
    assert N in (cfg.ssm.d_state, 256, 320, 384) and chunk in (cfg.ssm.chunk, 256, 512)
    assert max(N, chunk) > 128 or dtype == torch.float16
    f32 = torch.float32
    check_contract([(B, S, H, P), (B, S, H), (B, S, H, N), (B, S, H, N), (B * H, P, N)],
                   [dtype, f32, dtype, dtype, f32], (1,) * 5, True, chunk)
    assert chip_smoke.MAMBA_UPSTREAM_CHUNK == 256


def test_float16_limits_are_no_looser_than_bfloat16s():
    for table in (chip_smoke.TOL, chip_smoke.ROW_REL_TOL, chip_smoke.SSD_TOL,
                  chip_smoke.SSD_STEP_REL_TOL):
        assert table["float16"] <= table["bfloat16"]


def test_flash_bench_times_the_models_prefills():
    """The K1 source comparison (``kernels/flash_attention/bench.py``) runs
    at the prefill shapes the card check times, and Gemma-2-2B's hd 256."""
    from repro_torch.kernels.flash_attention import bench

    checked = {(B, H, KV, S, hd, causal)
               for (B, H, KV, S, _, hd, causal) in chip_smoke.FA_PREFILLS}
    checked.add((4, 16, 2, 1024, 128, True))  # qwen2.5-3b's, check_flash's last block
    (B, H, KV, S, hd), _ = chip_smoke.FA_CONTRACT["gemma-2-2b hd 256"]
    checked.add((B, H, KV, S, hd, True))
    assert set(bench.PREFILLS.values()) == checked


def test_the_contract_cases_cover_every_dtype_past_256():
    """K1 at hd 300, 320, 384 and 512 and K2 at chunk 512 and N = 320 and
    384 each run in float32, bfloat16 and float16; the float64 comparison
    runs at K2's chunk-512 float32 case."""
    dtypes = {torch.float32, torch.bfloat16, torch.float16}
    for hd in (300, 320, 384, 512):
        assert {dt for (shape, dt) in chip_smoke.FA_CONTRACT.values() if shape[4] == hd} == dtypes
    for N, chunk in ((128, 512), (320, 128), (384, 128)):
        assert {dt for (shape, q, dt) in chip_smoke.SSD_CONTRACT.values()
                if (shape[4], q) == (N, chunk)} == dtypes
    assert chip_smoke.SSD_CONTRACT[chip_smoke.SSD_F64_CASE][1:] == (512, torch.float32)
    assert chip_smoke.F64_NOISE == chip_smoke.FORWARD_NOISE
