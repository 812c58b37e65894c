"""The decode step as a CUDA graph (``repro_torch.models.decode_graph``).

On the CPU: the key, the policy and its bound on the graphs kept (with a
stand-in for the captured graph), which calls stay eager, and ``init_cache``'s zeros
against the one-layer-then-repeat form it replaced.  On the card (``-m
card``; skipped without one), at published widths and cut depth: 15 steps
through graphs against 15 eager steps from the same prefill, for a dense, a
hybrid (its rings wrapping), an SSM and an MLA + MoE model.  This file
imports no JAX, so the card runs it: ``python -m pytest --noconftest -m card
tests/test_torch_decode_graph.py``.
"""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention as attn_mod
from repro_torch.models import decode_graph
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tx
from repro_torch.runtime import trace

MODES = ("eager", "capture", "replay")


def _step_inputs(arch="qwen2.5-3b", B=2, max_len=12, **over):
    cfg = get_smoke_config(arch, **over)
    params = tx.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tx.init_cache(cfg, B, max_len, device="cpu")
    tokens = torch.zeros((B, 1), dtype=torch.int64)
    positions = torch.full((B, 1), 3, dtype=torch.int64)
    return cfg, params, cache, tokens, positions, tx.RunCtx(decode=True)


def _key(inputs):
    return decode_graph.key(*inputs)


def _swap_leaf(tree, path, fn):
    """A copy of the dict tree with the leaf at ``path`` replaced by fn(leaf)."""
    out = dict(tree)
    if len(path) == 1:
        out[path[0]] = fn(tree[path[0]])
    else:
        out[path[0]] = _swap_leaf(tree[path[0]], path[1:], fn)
    return out


# -- the key -----------------------------------------------------------------

#: ways to change a step's inputs, and whether the key must change
CHANGES = {
    "same tensors in new dicts": (lambda c, p, k, t, q, x: (
        c, dict(p), {g: dict(v) for g, v in k.items()}, t, q, x), False),
    "other token values": (lambda c, p, k, t, q, x: (c, p, k, t + 5, q, x), False),
    "other positions": (lambda c, p, k, t, q, x: (c, p, k, t, q + 1, x), False),
    "an equal config, a new object": (lambda c, p, k, t, q, x: (
        c.replace(), p, k, t, q, x), False),
    "a cache leaf moved": (lambda c, p, k, t, q, x: (
        c, p, _swap_leaf(k, ("layers", "k"), torch.clone), t, q, x), True),
    "the cache length moved": (lambda c, p, k, t, q, x: (
        c, p, _swap_leaf(k, ("layers", "length"), torch.clone), t, q, x), True),
    "a parameter moved": (lambda c, p, k, t, q, x: (
        c, _swap_leaf(p, ("layers", "attn", "w_q"), torch.clone), k, t, q, x), True),
    "the embedding moved": (lambda c, p, k, t, q, x: (
        c, _swap_leaf(p, ("embedding", "embed"), torch.clone), k, t, q, x), True),
    "a longer cache": (lambda c, p, k, t, q, x: (
        c, p, tx.init_cache(c, 2, 13, device="cpu"), t, q, x), True),
    "a cache leaf's dtype": (lambda c, p, k, t, q, x: (
        c, p, _swap_leaf(k, ("layers", "v"), lambda v: v.to(torch.float16)), t, q, x), True),
    "a cache leaf's strides": (lambda c, p, k, t, q, x: (
        c, p, _swap_leaf(k, ("layers", "k"), lambda v: v.transpose(1, 2).contiguous()
                         .transpose(1, 2)), t, q, x), True),
    "a parameter's dtype": (lambda c, p, k, t, q, x: (
        c, _swap_leaf(p, ("final_norm", "scale"), lambda v: v.to(torch.float64)), k, t, q,
        x), True),
    "a parameter's shape at the same address": (lambda c, p, k, t, q, x: (
        c, _swap_leaf(p, ("final_norm", "scale"), lambda v: v[:-1]), k, t, q, x), True),
    "a wider batch": (lambda c, p, k, t, q, x: (
        c, p, k, torch.cat([t, t]), torch.cat([q, q]), x), True),
    "the tokens' dtype": (lambda c, p, k, t, q, x: (c, p, k, t.int(), q, x), True),
    "the positions' dtype": (lambda c, p, k, t, q, x: (c, p, k, t, q.int(), x), True),
    "another config": (lambda c, p, k, t, q, x: (
        c.replace(aligned_decode=True), p, k, t, q, x), True),
    "another context": (lambda c, p, k, t, q, x: (
        c, p, k, t, q, dataclasses.replace(x, ep_axis="tp")), True),
}


@pytest.mark.parametrize("change", list(CHANGES))
def test_the_key_changes_with_an_address_a_shape_or_a_dtype_and_with_nothing_else(change):
    inputs = _step_inputs()
    fn, moves = CHANGES[change]
    before, after = _key(inputs), _key(fn(*inputs))
    assert (before != after) is moves


# -- the policy and its bound ---------------------------------------------------

class _StandIn:
    """Stands in for a captured graph on the CPU: runs the body at capture
    and at every call."""

    made = 0

    def __init__(self, body, tokens, positions):
        type(self).made += 1
        self.body = body

    def __call__(self, tokens, positions):
        return self.body(tokens, positions)


@pytest.fixture
def stand_in(monkeypatch):
    _StandIn.made = 0
    monkeypatch.setattr(decode_graph, "_Graph", _StandIn)
    return _StandIn


def _held(graphs):
    """(keys held, captured graphs held) in all."""
    return len(graphs._kept), sum(g is not None for g in graphs._kept.values())


def _modes(graphs, keys):
    """The mode each step of ``keys`` took, from the counters."""
    out = []
    for key in keys:
        before = trace.counts()
        graphs.step(key, lambda t, p: t + p, torch.ones(1), torch.ones(1))
        after = trace.counts()
        (mode,) = [m for m in MODES
                   if after.get(f"decode_graph.{m}", 0) > before.get(f"decode_graph.{m}", 0)]
        out.append(mode)
    return out


def test_a_key_runs_eagerly_then_captures_then_replays(stand_in):
    graphs = decode_graph.DecodeGraphs()
    key = ("sig", "a")
    assert _modes(graphs, [key] * 5) == ["eager", "capture", "replay", "replay", "replay"]
    assert stand_in.made == 1 and _held(graphs) == (1, 1)
    assert torch.equal(graphs.step(key, lambda t, p: t + p, torch.ones(1), torch.ones(1)),
                       torch.full((1,), 2.0))


def test_at_most_two_keys_are_kept_in_the_process(stand_in):
    graphs = decode_graph.DecodeGraphs()
    a, b, c = (("sig", n) for n in "abc")
    other = ("other", "a")
    assert _modes(graphs, [a, a, b, b, a, b]) == [
        "eager", "capture", "eager", "capture", "replay", "replay"]
    assert _held(graphs) == (2, 2)
    # a third key pushes out the least recently used (a)
    assert _modes(graphs, [c]) == ["eager"]
    assert _held(graphs) == (2, 1)
    assert _modes(graphs, [b, a]) == ["replay", "eager"]
    assert _held(graphs) == (2, 1)
    # a key of another shape signature takes one of the same two places:
    # b and its graph go
    assert _modes(graphs, [other, other]) == ["eager", "capture"]
    assert _held(graphs) == (2, 1)
    # and two new keys push out every graph
    assert _modes(graphs, [b, a]) == ["eager", "eager"]
    assert _held(graphs) == (2, 0)


@pytest.mark.parametrize("order", ["abab", "abcabc", "aabbccaa", "abcdabcd", "aAbBaAbB"])
def test_the_process_never_holds_more_than_two_keys(stand_in, order):
    graphs = decode_graph.DecodeGraphs()
    for name in order * 3:
        # upper case: a key of another shape signature
        _modes(graphs, [("big" if name.isupper() else "small", name.lower())])
        assert _held(graphs)[0] <= decode_graph.KEPT == 2
    assert _held(graphs)[1] <= 2


def test_no_key_runs_eagerly(stand_in):
    graphs = decode_graph.DecodeGraphs()
    assert _modes(graphs, [None] * 3) == ["eager"] * 3
    assert stand_in.made == 0


# -- which steps stay eager -------------------------------------------------------

def test_cpu_tensors_stay_eager_and_the_span_says_so():
    cfg, params, cache, tokens, positions, ctx = _step_inputs()
    assert decode_graph.eager_reason(params, cache, tokens, positions, ctx) == \
        "not all on one CUDA device"
    before = trace.counter("decode_graph.eager")
    with trace.enabled(), torch.inference_mode():
        t0 = time.perf_counter_ns()
        logits, out = tx.decode_step(cfg, params, cache, tokens, positions, ctx)
    (step,) = [s for s in trace.spans("decode_step") if s.t0 >= t0]
    assert step.attrs["graph"] == "eager"
    assert trace.counter("decode_graph.eager") == before + 1
    assert out is cache and logits.shape == (2, 1, cfg.vocab_size)
    # the module spans of an eager step are recorded
    assert any(s.name == "layer" and s.t0 >= t0 for s in trace.spans())


def test_a_mesh_stays_eager():
    cfg, params, cache, tokens, positions, ctx = _step_inputs()
    ctx = dataclasses.replace(ctx, mesh=object())
    assert decode_graph.eager_reason(params, cache, tokens, positions, ctx) == "a mesh"


def test_a_leaf_autograd_records_stays_eager():
    cfg, params, cache, tokens, positions, ctx = _step_inputs()
    params = _swap_leaf(params, ("final_norm", "scale"), lambda v: v.requires_grad_())
    assert decode_graph.eager_reason(params, cache, tokens, positions, ctx) == \
        "autograd records the step"
    with torch.no_grad():
        assert decode_graph.eager_reason(params, cache, tokens, positions, ctx) != \
            "autograd records the step"


@pytest.mark.parametrize("mode", ["an op counter", "fake tensors"])
def test_a_step_under_a_dispatch_mode_stays_eager(mode):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_analysis import OpCounter

    cfg, params, cache, tokens, positions, ctx = _step_inputs()
    under = OpCounter() if mode == "an op counter" else FakeTensorMode(
        allow_non_fake_inputs=True)
    with under:
        assert decode_graph.eager_reason(params, cache, tokens, positions, ctx) == \
            "a dispatch mode is active"
    assert decode_graph.eager_reason(params, cache, tokens, positions, ctx) == \
        "not all on one CUDA device"


def test_a_meta_step_stays_eager():
    cfg, params, cache, tokens, positions, ctx = _step_inputs()
    meta = tx.init_cache(cfg, 2, 12, device="meta")
    assert decode_graph.eager_reason(params, meta, tokens, positions, ctx) == \
        "not all on one CUDA device"


def test_a_dtensor_leaf_stays_eager_and_the_span_says_so():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cfg, params, cache, tokens, positions, ctx = _step_inputs()
    dist.init_process_group("fake", rank=0, world_size=1, store=FakeStore())
    try:
        mesh = init_device_mesh("cpu", (1,))
        cache = _swap_leaf(cache, ("layers", "length"),
                           lambda v: distribute_tensor(v, mesh, [Replicate()]))
        assert decode_graph.eager_reason(params, cache, tokens, positions, ctx) == \
            "a DTensor leaf"
        graphs = decode_graph.DecodeGraphs()
        with trace.enabled():
            t0 = time.perf_counter_ns()
            graphs.step(None, lambda t, p: t, tokens, positions)
        (step,) = [s for s in trace.spans("decode_step") if s.t0 >= t0]
        assert step.attrs["graph"] == "eager"
    finally:
        dist.destroy_process_group()


# -- init_cache ----------------------------------------------------------------------

def _repeat_form(cfg, batch, max_len):
    """``init_cache`` as it was: one layer's zeros, repeated over the group."""
    cache = {}
    for group in tx.layer_groups(cfg):
        if group.kind == "ssm":
            one = ssm_mod.init_mamba_cache(cfg, batch, device="cpu")
        elif group.kind == "hybrid":
            one = {"attn": attn_mod.init_kv_cache(cfg, batch, max_len, group.window,
                                                  device="cpu"),
                   "ssm": ssm_mod.init_mamba_cache(cfg, batch, device="cpu")}
        elif cfg.mla is not None:
            one = attn_mod.init_mla_cache(cfg, batch, max_len, device="cpu")
        else:
            one = attn_mod.init_kv_cache(cfg, batch, max_len, device="cpu")
        cache[group.name] = tx._tree_map(
            lambda t: t[None].repeat(group.count, *([1] * t.dim())), one)
    return cache


@pytest.mark.parametrize("arch,max_len", [
    ("qwen2.5-3b", 24),            # dense
    ("hymba-1.5b", 40),            # hybrid: rings (window 16) and linear caches
    ("hymba-1.5b", 12),            # hybrid, the ring cut to max_len
    ("mamba2-130m", 24),           # SSM
    ("deepseek-v2-lite-16b", 24),  # MLA's latent cache, MoE groups
])
def test_init_cache_gives_the_repeat_forms_zeros_in_one_allocation(arch, max_len):
    cfg = get_smoke_config(arch)
    got, want = tx.init_cache(cfg, 3, max_len, device="cpu"), _repeat_form(cfg, 3, max_len)
    assert got.keys() == want.keys()
    g_leaves, w_leaves = list(decode_graph._leaves(got)), list(decode_graph._leaves(want))
    assert len(g_leaves) == len(w_leaves) > 0
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype and g.device == w.device
        assert g.is_contiguous() and torch.equal(g, w)
    # views of one block, each aligned, none overlapping another
    base = g_leaves[0].untyped_storage().data_ptr()
    assert {t.untyped_storage().data_ptr() for t in g_leaves} == {base}
    spans = sorted((t.data_ptr() - base, t.data_ptr() - base + t.nbytes) for t in g_leaves)
    assert all(a % tx.CACHE_ALIGN == 0 for a, _ in spans)
    assert all(b <= a2 for (_, b), (a2, _) in zip(spans, spans[1:]))
    # a write to one leaf leaves every other at zero
    g_leaves[0].fill_(1)
    assert all(not t.any() for t in g_leaves[1:])
    if arch == "hymba-1.5b":
        sizes = {leaf.shape[2] for name, grp in got.items() for leaf in [grp["attn"]["k"]]}
        assert sizes == {min(cfg.sliding_window, max_len), max_len}


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this machine has none")
    return torch.device("cuda", 0)


B, PROMPT, STEPS = 4, 64, 15
#: published widths, cut depth, bf16 weights and compute; hymba's window cut
#: under PROMPT + STEPS, so its rings wrap during the steps
CARD_CONFIGS = {
    "phi4-mini-3.8b": dict(num_layers=2),
    "hymba-1.5b": dict(num_layers=3, global_layers=(0,), sliding_window=PROMPT + 6),
    "mamba2-130m": dict(num_layers=2),
    "deepseek-v2-lite-16b": dict(num_layers=2),
}


def _serve(cfg, params, prompt, card):
    """Prefill, then STEPS greedy decode steps: the tokens, each step's
    logits with a copy taken when it was returned, and the cache."""
    with torch.inference_mode():
        cache = tx.init_cache(cfg, B, PROMPT + STEPS + 1, device=card)
        logits, cache = tx.prefill(cfg, params, prompt, cache, tx.RunCtx(decode=True))
        tok = logits[:, -1:].argmax(-1)
        out, kept = [tok], []
        for i in range(STEPS):
            pos = torch.full((B, 1), PROMPT + i, dtype=torch.int64, device=card)
            logits, cache = tx.decode_step(cfg, params, cache, tok, pos,
                                           tx.RunCtx(decode=True))
            kept.append((logits, logits.clone()))
            tok = logits[:, -1:].argmax(-1)
            out.append(tok)
        torch.cuda.synchronize(card)
    return torch.cat(out, dim=1), kept, cache


@pytest.mark.card
@pytest.mark.parametrize("arch", list(CARD_CONFIGS))
def test_graph_steps_equal_eager_steps_on_the_card(card, monkeypatch, arch):
    cfg = get_config(arch, attention_impl="pallas", param_dtype=torch.bfloat16,
                     compute_dtype=torch.bfloat16, **CARD_CONFIGS[arch])
    params = tx.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), device=card,
                           generator=torch.Generator(device=card).manual_seed(1))

    with monkeypatch.context() as m:
        m.setattr(decode_graph, "eager_reason", lambda *args: "the eager reference")
        toks_e, kept_e, cache_e = _serve(cfg, params, prompt, card)
    graphs = decode_graph.DecodeGraphs()
    monkeypatch.setattr(decode_graph, "GRAPHS", graphs)
    trace.reset_counts(*(f"decode_graph.{m}" for m in MODES))
    toks_g, kept_g, cache_g = _serve(cfg, params, prompt, card)
    assert [trace.counter(f"decode_graph.{m}") for m in MODES] == [1, 1, STEPS - 2]

    # the same kernels in the same order: equal bit for bit
    assert torch.equal(toks_g, toks_e)
    for (got, _), (want, _) in zip(kept_g, kept_e):
        assert torch.equal(got, want)
    for got, want in zip(decode_graph._leaves(cache_g), decode_graph._leaves(cache_e)):
        assert torch.equal(got, want)
    # a step's logits, kept, never change under the caller
    for got, copy in kept_g:
        assert torch.equal(got, copy)

    # a second cache of the same shapes: its steps replay where it lands on
    # the first one's addresses, else one eager step and one capture
    del cache_g, kept_g
    trace.reset_counts(*(f"decode_graph.{m}" for m in MODES))
    toks_2, _, _ = _serve(cfg, params, prompt, card)
    counts = [trace.counter(f"decode_graph.{m}") for m in MODES]
    assert counts in ([0, 0, STEPS], [1, 1, STEPS - 2]), counts
    assert torch.equal(toks_2, toks_e)
    assert _held(graphs)[1] <= decode_graph.KEPT
