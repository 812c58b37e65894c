"""DeepSeek-V2's published maths in the port, and its serving prefill.

The port's options (``MLAConfig.latent_norm``, ``ModelConfig.yarn``,
``MoEConfig.norm_topk_prob`` and ``dense_d_ff``) all on, at small sizes on
the CPU in float32: a prefill and decode steps through the latent cache
give the logits of ``plain_deepseek_v2``'s full forward.  The MoE layers'
routed form (a prefill on one device) gives the dense form's output, with
an expert that no token chooses and one that every token chooses; YaRN's
frequencies and scale are DeepSeek-V2-Lite's constants; each option off
leaves today's maths, bit for bit; MLA's prefill on the flash kernel's
route (the kernel's plain version here) pads v to q . k's width, passes
YaRN's scale and writes the cache rows the absorbed prefill writes.  One
``card`` test holds both new prefill paths to the old ones at full width on
one layer; it imports no JAX (run it with ``--noconftest``).
"""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

import plain_deepseek_v2 as plain
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, layers, moe
from repro_torch.models import transformer as tx
from repro_torch.models.common import MLAConfig, MoEConfig, YarnConfig
from repro_torch.runtime import trace

torch.set_num_threads(1)

ARCH = "deepseek-v2-lite-16b"
#: DeepSeek-V2-Lite's rope_scaling (its config.json)
YARN = {"factor": 40.0, "original_max_position_embeddings": 4096, "beta_fast": 32.0,
        "beta_slow": 1.0, "mscale": 0.707, "mscale_all_dim": 0.707}
#: the port's smoke sizes with every published option on, as a file's ``model``
MODEL = {"num_layers": 3, "d_model": 64, "num_heads": 4, "vocab_size": 256,
         "norm_eps": 1e-6, "rope_theta": 10000.0, "yarn": YARN,
         "mla": {"kv_lora_rank": 32, "qk_rope_dim": 8, "qk_nope_dim": 16, "v_head_dim": 16,
                 "latent_norm": True},
         "moe": {"num_experts": 8, "top_k": 2, "num_shared": 1, "expert_d_ff": 64,
                 "first_dense": 1, "norm_topk_prob": False, "dense_d_ff": 96}}


def published(impl: str = "reference", **over):
    """The smoke config with every published option on."""
    cfg = get_smoke_config(ARCH, attention_impl=impl)
    return cfg.replace(
        mla=dataclasses.replace(cfg.mla, latent_norm=True),
        moe=dataclasses.replace(cfg.moe, norm_topk_prob=False, dense_d_ff=96),
        yarn=YarnConfig(**YARN), **over)


def _params(cfg, seed=0):
    params = tx.init_params(cfg, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for group in ("dense0", "moe"):
        norm = params[group]["attn"].get("kv_norm")
        if norm is not None:  # a scale other than ones, so that a dropped one shows
            norm["scale"].copy_(1 + 0.5 * torch.rand(norm["scale"].shape, generator=gen))
    return params


def test_the_moe_stack_follows_the_moe_block_not_the_family_name():
    """A config with ``moe`` stacks its MoE layers whatever its family is
    called (the benchmark's file names it ``deepseek_v2``): the same tree and
    the same logits as the zoo's family ``moe``."""
    cfg = published()
    named = cfg.replace(family="deepseek_v2")
    assert [g.kind for g in tx.layer_groups(named)] == ["dense", "moe"]
    params, theirs = _params(cfg), _params(named)
    assert list(tx._leaves(params)) and all(
        torch.equal(a, b) for a, b in zip(tx._leaves(params), tx._leaves(theirs), strict=True))
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want, _, _ = tx.forward(cfg, params, tokens)
        got, _, _ = tx.forward(named, theirs, tokens)
    assert torch.equal(got, want)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_prefill_and_decode_match_the_plain_forward(impl):
    """The serving path (routed experts in prefill; with ``pallas`` MLA's
    prompt attention on the kernel's route) against the full forward."""
    cfg = published(impl)
    params = _params(cfg)
    assert params["dense0"]["mlp"]["w_gate"].shape == (1, 64, 96)
    B, S, T = 2, 12, 20
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(3))
    want = plain.forward(MODEL, params, tokens)
    ctx = tx.RunCtx(decode=True)
    with torch.no_grad():
        cache = tx.init_cache(cfg, B, T + 1, device="cpu")
        logits, cache = tx.prefill(cfg, params, tokens[:, :S], cache, ctx)
        got = [logits[:, -1]]
        for i in range(S, T - 1):
            pos = torch.full((B, 1), i, dtype=torch.int64)
            logits, cache = tx.decode_step(cfg, params, cache, tokens[:, i:i + 1], pos, ctx)
            got.append(logits[:, -1])
    torch.testing.assert_close(torch.stack(got, 1), want[:, S - 1:T - 1], rtol=1e-4, atol=1e-4)


def _skewed(cfg, N=40, seed=0):
    """Layer params and tokens under which expert 0 takes every token and
    expert E - 1 none."""
    p = moe.init_moe(cfg, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    u = torch.randn(cfg.d_model, generator=gen)
    u = u / u.norm()
    p["router"][:, 0] = 50 * u
    p["router"][:, -1] = -50 * u
    x = torch.randn(1, N, cfg.d_model, generator=gen) + 3 * u
    return p, x


@pytest.mark.parametrize("norm_topk", [True, False])
def test_the_routed_form_is_the_dense_form(norm_topk):
    cfg = get_smoke_config(ARCH)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, norm_topk_prob=norm_topk))
    p, x = _skewed(cfg)
    _, top_i, _ = moe._router(cfg, p, x[0])
    loads = torch.bincount(top_i.reshape(-1), minlength=cfg.moe.num_experts)
    assert loads[0] == x.shape[1] and loads[-1] == 0
    counts = trace.counts()
    y_routed, aux_routed = moe.apply_moe(cfg, p, x, prefill=True)
    y_dense, aux_dense = moe.apply_moe(cfg, p, x)
    after = trace.counts()
    pairs = {k: after.get(k, 0) - counts.get(k, 0) for k in (moe.ROUTED_PAIRS, moe.DENSE_PAIRS)}
    assert pairs == {moe.ROUTED_PAIRS: x.shape[1] * cfg.moe.top_k,
                     moe.DENSE_PAIRS: x.shape[1] * cfg.moe.num_experts}
    torch.testing.assert_close(y_routed, y_dense, rtol=0, atol=1e-5)
    assert torch.equal(aux_routed, aux_dense)


def test_the_routed_form_records_its_spans():
    cfg = get_smoke_config(ARCH)
    p, x = _skewed(cfg)
    with trace.enabled():
        t0 = max((s.t1 for s in trace.spans()), default=0)
        moe.apply_moe(cfg, p, x, prefill=True)
        mine = [s for s in trace.spans() if s.t0 > t0]
    by = {s.name: s for s in mine}
    assert [s.name for s in mine] == ["moe.route", "moe.experts", "moe.shared"]
    N, k, E = x.shape[1], cfg.moe.top_k, cfg.moe.num_experts
    assert by["moe.route"].attrs == {"form": "routed", "tokens": N, "pairs": N * k}
    assert by["moe.experts"].attrs["form"] == "routed"
    assert by["moe.experts"].attrs["largest"] == N and by["moe.experts"].attrs["experts"] < E


def test_yarn_frequencies_and_scale_are_deepseek_v2_lites():
    y = YarnConfig(**YARN)
    assert math.floor(layers._yarn_dim(32, 64, 10000.0, 4096)) == 10
    assert math.ceil(layers._yarn_dim(1, 64, 10000.0, 4096)) == 23
    e = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    ramp = ((torch.arange(32, dtype=torch.float64) - 10) / 13).clamp(0, 1)
    want = e / 40 * ramp + e * (1 - ramp)
    got = torch.as_tensor(layers.yarn_inv_freq(64, 10000.0, y))
    torch.testing.assert_close(got, want, rtol=1e-15, atol=0)
    assert ramp[10] == 0 and ramp[23] == 1  # plain up to dim 10, over 40 from dim 23
    assert layers.yarn_mscale(40, 0.707) ** 2 == pytest.approx(1.5896262, abs=1e-7)
    cfg = get_smoke_config(ARCH).replace(
        mla=MLAConfig(kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128),
        yarn=y)
    assert attention.mla_scale(cfg) == pytest.approx(0.1147214, abs=1e-7)
    assert attention.mla_scale(cfg.replace(yarn=None)) == 192 ** -0.5
    # cos and sin take m(factor, mscale) / m(factor, mscale_all_dim): 1 as published
    x = torch.randn(2, 5, 3, 64)
    pos = torch.arange(5)[None].expand(2, 5)
    same = layers.apply_rope(x, pos, 10000.0, y)
    louder = layers.apply_rope(x, pos, 10000.0, dataclasses.replace(y, mscale_all_dim=0.0))
    torch.testing.assert_close(louder, same * layers.yarn_mscale(40, 0.707))


def _todays_rope(x, positions, theta):
    """``apply_rope`` as it was before YaRN."""
    freqs = torch.as_tensor(layers.rope_frequencies(x.shape[-1], theta), dtype=torch.float32)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@pytest.mark.parametrize("option", ["yarn", "latent_norm", "norm_topk_prob", "dense_d_ff"])
def test_each_option_off_is_todays_maths(option, monkeypatch):
    cfg = get_smoke_config(ARCH)
    assert (cfg.yarn, cfg.mla.latent_norm, cfg.moe.norm_topk_prob, cfg.moe.dense_d_ff) == (
        None, False, True, 0)
    gen = torch.Generator().manual_seed(5)
    if option == "yarn":
        x = torch.randn(2, 7, 4, 8, generator=gen)
        pos = torch.arange(7)[None].expand(2, 7)
        assert torch.equal(layers.apply_rope(x, pos, 10000.0), _todays_rope(x, pos, 10000.0))
        assert attention.mla_scale(cfg) == (16 + 8) ** -0.5
    elif option == "latent_norm":
        # off: no leaf, and the layer is the one with the norm taken out
        on = cfg.replace(mla=dataclasses.replace(cfg.mla, latent_norm=True))
        p_on = attention.init_attention(on, torch.Generator().manual_seed(1))
        p_off = attention.init_attention(cfg, torch.Generator().manual_seed(1))
        assert list(p_on) == ["w_q", "w_dkv", "kv_norm", "w_uk", "w_uv", "w_o"]
        assert list(p_off) == ["w_q", "w_dkv", "w_uk", "w_uv", "w_o"]
        x = torch.randn(2, 6, cfg.d_model, generator=gen)
        pos = torch.arange(6)[None].expand(2, 6)
        off, _ = attention.apply_mla(cfg, p_off, x, positions=pos)
        monkeypatch.setattr(attention, "apply_norm", lambda cfg, p, t: t)
        skipped, _ = attention.apply_mla(on, p_on, x, positions=pos)
        assert torch.equal(off, skipped)
    elif option == "norm_topk_prob":
        p = moe.init_moe(cfg, torch.Generator().manual_seed(2))
        x2 = torch.randn(9, cfg.d_model, generator=gen)
        probs, top_i, top_w = moe._router(cfg, p, x2)
        raw = torch.topk(probs, cfg.moe.top_k, dim=-1).values
        assert torch.equal(top_w, raw / torch.clamp(raw.sum(-1, keepdim=True), min=1e-9))
        off = cfg.replace(moe=dataclasses.replace(cfg.moe, norm_topk_prob=False))
        assert torch.equal(moe._router(off, p, x2)[2], raw)
    else:
        params = tx.init_params(cfg, torch.Generator().manual_seed(0))
        mo = cfg.moe
        assert params["dense0"]["mlp"]["w_gate"].shape[-1] == (
            (mo.top_k + mo.num_shared) * mo.expert_d_ff)


def test_mla_prefill_on_the_kernel_route(monkeypatch):
    """The kernel's route takes q . k and a zero-padded v at one head dim and
    YaRN's scale, writes the rows the absorbed prefill writes, and gives its
    output."""
    calls = []
    real = attention.flash_attention_gqa

    def recording(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention_gqa", recording)
    cfg = published("pallas")
    m = cfg.mla
    p = _params(cfg)["moe"]
    p = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
         for k, v in p["attn"].items()}
    B, S = 2, 10
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(4))
    pos = torch.arange(S)[None].expand(B, S)
    caches, outs = {}, {}
    for impl in ("pallas", "reference"):
        c = cfg.replace(attention_impl=impl)
        cache = attention.init_mla_cache(c, B, S + 4, device="cpu")
        with torch.no_grad():
            outs[impl], caches[impl] = attention.apply_mla(
                c, p, x, positions=pos, cache=cache, ctx=tx.RunCtx(prefill=True))
    (q, k, v, kw), = calls
    qk = m.qk_nope_dim + m.qk_rope_dim
    assert q.shape == k.shape == v.shape == (B, cfg.num_heads, S, qk)
    assert torch.all(v[..., m.v_head_dim:] == 0) and v[..., :m.v_head_dim].abs().sum() > 0
    assert kw == {"causal": True, "scale": attention.mla_scale(cfg), "window": 0}
    for leaf in ("c", "k_rope", "length"):
        assert torch.equal(caches["pallas"][leaf], caches["reference"][leaf]), leaf
    assert caches["pallas"]["length"].tolist() == [S, S]
    torch.testing.assert_close(outs["pallas"], outs["reference"], rtol=1e-5, atol=1e-5)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.card
def test_new_prefill_paths_at_full_width_on_one_layer():
    """DeepSeek-V2-Lite's widths in bf16, one MoE layer over 2 x 4,096
    tokens: the routed form against the dense form (the same routing; the
    f32 sums in another order, the experts' rows through other GEMM
    shapes), and MLA's prefill on K1 against the absorbed prefill (bf16
    inputs to an f32 online softmax on both sides), with the cache rows
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this machine has none")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tx.ModelConfig(
        name="dsv2-lite-one-layer", family="moe", num_layers=2, d_model=2048, num_heads=16,
        num_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=102400,
        mla=MLAConfig(kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
                      latent_norm=True),
        moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, expert_d_ff=1408, first_dense=1,
                      norm_topk_prob=False, dense_d_ff=10944),
        yarn=YarnConfig(**YARN), param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
        attention_impl="pallas")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S = 2, 4096
    x = torch.randn(B, S, cfg.d_model, device=dev, generator=gen).to(torch.bfloat16)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    with torch.inference_mode():
        p = moe.init_moe(cfg, gen)
        routed, _ = moe.apply_moe(cfg, p, x, prefill=True)
        dense, _ = moe.apply_moe(cfg, p, x)
        assert _rel(routed, dense) < 5e-3, _rel(routed, dense)
        del p
        a = attention.init_attention(cfg, gen)
        caches, outs = {}, {}
        for impl in ("pallas", "reference"):
            c = cfg.replace(attention_impl=impl)
            cache = attention.init_mla_cache(c, B, S + 1, device=dev)
            outs[impl], caches[impl] = attention.apply_mla(
                c, a, x, positions=pos, cache=cache, ctx=tx.RunCtx(prefill=True))
        for leaf in ("c", "k_rope", "length"):
            assert torch.equal(caches["pallas"][leaf], caches["reference"][leaf]), leaf
        assert _rel(outs["pallas"], outs["reference"]) < 2e-2, _rel(outs["pallas"],
                                                                    outs["reference"])
