"""Serve a small LM through the streaming data plane, on the PyTorch port:
request topic -> continuous batcher -> response topic, with
proxy-distributed weights.

The counterpart of ``examples/serve_batched.py`` on ``repro_torch``.  A
"trainer" publishes a checkpoint through the port's ``CheckpointManager``;
the server restores it *lazily*: a tree of unresolved proxies, each weight
resolved from the store onto the device just in time -- the pass-by-
reference win applied to model loading and restart storms.

Requests enter as stream items (prompt bytes ride the cluster store tiers;
only metadata events touch the broker); the ``ModelServer`` batcher groups
them dynamically, ``generate`` pads each batch to the serving width, runs
one prefill, then steps the KV cache token by token; responses flow back on
a reply topic.

Runs on the GPU unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/serve_batched_torch.py
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.api import ClusterSpec, ConnectorSpec, ServeSpec, Session, StoreConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import is_proxy
from repro_torch.launch.serve import resolve_device
from repro_torch.models import transformer as tx
from repro_torch.train.checkpoint import CheckpointManager

BATCH, PROMPT_LEN, GEN_TOKENS, REQUESTS = 4, 16, 24, 8


def make_generate(cfg, params, device):
    """One forward pass for a dynamic batch: pad to the serving width,
    prefill once, then decode greedily token by token."""

    @torch.inference_mode()
    def generate(prompts: list) -> list:
        k = len(prompts)
        toks = np.stack([np.asarray(p, np.int64) for p in prompts])
        if k < BATCH:
            toks = np.concatenate([toks, np.zeros((BATCH - k, PROMPT_LEN), np.int64)])
        cache = tx.init_cache(cfg, BATCH, PROMPT_LEN + GEN_TOKENS + 1, device=device)
        logits, cache = tx.prefill(cfg, params, torch.from_numpy(toks).to(device), cache)
        tok = logits[:, -1:].argmax(-1)
        generated = [tok]
        for i in range(GEN_TOKENS - 1):
            pos = torch.full((BATCH, 1), PROMPT_LEN + i, dtype=torch.int64, device=device)
            logits, cache = tx.decode_step(cfg, params, cache, tok, pos)
            tok = logits[:, -1:].argmax(-1)
            generated.append(tok)
        full = torch.cat(generated, dim=1).to(torch.int32).cpu().numpy()
        return [full[i] for i in range(k)]

    return generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)

    store = StoreConfig(
        "serve-store-torch", ConnectorSpec("memory", segment="serve-torch")
    ).build(register=True)
    with tempfile.TemporaryDirectory() as run_dir:
        ckpt = CheckpointManager(store, f"{run_dir}/ckpt_index.json", keep=1)

        # "trainer" published a checkpoint
        ckpt.save(0, tx.init_params(cfg, torch.Generator(device=device).manual_seed(0)),
                  blocking=True)

        # "server" restores lazily: a tree of unresolved proxies
        _, lazy = ckpt.restore_lazy()
        leaves = [leaf for _, leaf in bridge.flatten(lazy)]
        print(f"restored {len(leaves)} weight shards as proxies "
              f"(resolved so far: 0/{len(leaves)})")
        assert all(is_proxy(leaf) for leaf in leaves)
        # each leaf resolves from the store onto the device as it is reached
        params = bridge.params_from_jax(lazy, device=device)

    generate = make_generate(cfg, params, device)
    spec = ClusterSpec(n_workers=1, serve=ServeSpec(max_batch_size=BATCH, max_wait_ms=5.0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (PROMPT_LEN,)).astype(np.int32)
               for _ in range(REQUESTS)]
    t0 = time.perf_counter()
    with Session(cluster=spec, name="serve-example-torch") as session:
        server = session.serve(generate)
        server.attach(
            session.stream_consumer("requests"),
            session.stream_producer("responses"),
        )
        requests = session.stream_producer("requests")
        responses = session.stream_consumer("responses")
        keys = [requests.send(prompt) for prompt in prompts]
        requests.close()  # EOS flushes the batcher and closes the reply topic

        # each response names the key of the request it answers
        outs = {item.metadata["key"]: item.value for item in responses
                if item.metadata.get("status") == "ok"}
        dt = time.perf_counter() - t0
        stats = server.stats()
        hub = session.cluster.streams().stats()

    assert len(outs) == REQUESTS, f"served {len(outs)}/{REQUESTS} requests"
    print(f"served {REQUESTS} reqs (batch<={BATCH}, gen={GEN_TOKENS}) on {device} "
          f"in {dt:.2f}s: {stats['batches']} batches, "
          f"mean {stats['mean_batch']:.2f}, "
          f"p50/p99 {stats['latency_p50_ms']:.0f}/{stats['latency_p99_ms']:.0f} ms")
    print(f"broker carried {hub['broker_bytes']:,}B of events; "
          f"{hub['payload_bytes']:,}B of payload rode the store tiers")
    outputs = [outs[key] for key in keys]
    print("sample token ids:", outputs[0][:10].tolist())
    store.connector.clear()
    store.close()
    return {"prompts": prompts, "outputs": outputs,
            "params": params, "cfg": cfg, "server": stats, "seconds": dt}


if __name__ == "__main__":
    main()
