"""One run of one cell of ``BENCHMARK.json``.

    python -m chipbench.run --workload phi4-rag-closed --seed 7 --seconds 45 --trace 0

From the root of a checkout: makes the weights and prompts from ``--seed``,
serves them through ``repro_torch.api.Session`` (a ``ModelServer`` on the
``requests`` and ``responses`` topics, the batch function of
``chipbench.adapter``), warms up one batch of the cell's shapes, measures a
closed loop for ``--seconds``, checks a sample of the served tokens against
the plain reference, and prints one JSON line: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics and the device trace's breakdown
(``--trace 1``).  The numbers compared for ``correct`` end standard error
and the result line.  It needs as many CUDA devices as the cell names and
exits non-zero, printing no result, without them, or when the process holds
a module of JAX or of the JAX package ``repro`` after the window.
"""

from __future__ import annotations

import os
import time
from pathlib import Path


def _process_age_s() -> float:
    """Seconds since this process started (from /proc; 0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
#: build and kernel caches, at fixed paths inside the checkout
CACHE = CHECKOUT / ".chipbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
import typing  # noqa: E402
from typing import Any  # noqa: E402

import torch  # noqa: E402

from chipbench import check, registry, weights  # noqa: E402
from chipbench.adapter import BatchFn  # noqa: E402
from chipbench.devtrace import collect  # noqa: E402
from chipbench.loadgen import Traffic, closed_loop, prompt  # noqa: E402
from chipbench.record import Run  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds the warm batch may take (a first run in a checkout builds the kernels)
WARM_TIMEOUT_S = 1500.0
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def _port():
    src = str(CHECKOUT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.api import ClusterSpec, ServeSpec, Session
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    return ClusterSpec, ServeSpec, Session, get_config, transformer


#: the port's RMSNorm epsilon (a constant of its model code)
PORT_NORM_EPS = 1e-6


def _field(hint: Any, current: Any, value: Any) -> Any:
    """``value`` from the configuration file as the port's field of type
    ``hint`` (now ``current``) takes it: an object becomes the dataclass the
    field declares, the port's own with the keys the file states replaced
    (the class's defaults where the port has none); a list becomes a tuple
    where the field is one."""
    union = typing.get_origin(hint) in (typing.Union, types.UnionType)
    kinds = typing.get_args(hint) if union else (hint,)
    if isinstance(value, dict):
        if current is None:
            (cls,) = [k for k in kinds if dataclasses.is_dataclass(k)]
            current = cls()
        hints = typing.get_type_hints(type(current))
        return dataclasses.replace(current, **{k: _field(hints[k], getattr(current, k), v)
                                               for k, v in value.items()})
    if isinstance(value, list) and any(typing.get_origin(k) is tuple for k in kinds):
        return tuple(value)
    return value


def port_config(get_config, spec: dict[str, Any]):
    """The port's config for ``spec["port_arch"]`` with every size the file
    states, so that what runs is what the file says; a key the file leaves
    out keeps the port's value."""
    model = dict(spec["model"])
    eps = model.pop("norm_eps")
    if eps != PORT_NORM_EPS:
        raise ValueError(f"{spec['name']}: norm_eps {eps}; the port's norms use {PORT_NORM_EPS}")
    base = get_config(spec["port_arch"])
    hints = typing.get_type_hints(type(base))
    stated = {k: _field(hints[k], getattr(base, k), v) for k, v in model.items()}
    return base.replace(attention_impl=spec["attention_impl"],
                        param_dtype=DTYPES[spec["param_dtype"]],
                        compute_dtype=DTYPES[spec["compute_dtype"]], **stated)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: torch.device, *,
             root: Path = ROOT, control: str | None = None,
             t_start: float = T_START) -> dict[str, Any]:
    """Run the cell and return its result line's fields (``check`` last)."""
    bench = registry.benchmark(root)
    cell = registry.workload(bench, name)
    spec = registry.config(cell["config"], root)
    traffic = Traffic.from_file(cell["traffic"], registry.traffic(cell["traffic"], root))
    limits = registry.check(name, root)
    ref = registry.reference(spec["reference"], root)
    family = registry.family(spec["model"]["family"], root)
    readers = {m["name"]: (m, registry.metric_reader(m["name"], root))
               for m in registry.metrics_for(bench, name, trace)}
    ClusterSpec, ServeSpec, Session, get_config, tx = _port()
    cfg = port_config(get_config, spec)
    model = spec["model"]
    B, PL, G, V = traffic.batch, traffic.prompt_len, traffic.gen, model["vocab_size"]

    stamps = {"start": t_start, "imported": time.perf_counter()}
    params = weights.make(family.layout(model), seed, device, DTYPES[spec["param_dtype"]],
                          getattr(family, "INITS", None))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stamps["weights"] = time.perf_counter()
    fn = BatchFn(tx, cfg, params, batch=B, prompt_len=PL, gen=G, device=device)
    cluster = ClusterSpec(n_workers=1, serve=ServeSpec(max_batch_size=B,
                                                       max_wait_ms=traffic.max_wait_ms))
    prof = None
    with Session(cluster=cluster, name=f"chipbench-{name}") as session:
        server = session.serve(fn)
        server.attach(session.stream_consumer("requests"), session.stream_producer("responses"))
        requests = session.stream_producer("requests")
        responses = session.stream_consumer("responses")
        for i in range(B):  # the warm batch: the cell's shapes, every kernel built and loaded
            requests.send(prompt(seed, i, PL, V, stream=1))
        for _ in range(B):
            warm = responses.recv(timeout=WARM_TIMEOUT_S)
            if warm.metadata.get("status") != "ok":
                raise RuntimeError(f"the warm batch failed: {warm.value}")
        stamps["warm"] = time.perf_counter()
        fn.batches.clear()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        if trace:
            act = torch.profiler.ProfilerActivity
            prof = torch.profiler.profile(
                activities=[act.CUDA if device.type == "cuda" else act.CPU])
            prof.start()
        wall_ns = time.time_ns() - time.perf_counter_ns()  # perf_counter -> Unix clock
        window = closed_loop(requests, responses, clients=traffic.clients, seconds=seconds,
                             make_prompt=lambda i: prompt(seed, i, PL, V))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if prof is not None:
            prof.stop()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        requests.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stamps["closed"] = time.perf_counter()

    run = Run(workload=name, model=model, dtype=spec["compute_dtype"], traffic=traffic,
              window=window, batches=list(fn.batches), setup_s=window.t_first - t_start,
              peak_bytes=int(peak), family=family)
    result: dict[str, Any] = {}
    if prof is not None:
        to_ns = lambda t: int(t * 1e9) + wall_ns  # noqa: E731
        run.trace = collect(prof, to_ns(window.t_first), to_ns(window.t_last))
        del prof
        phases = []
        for b in run.batches:
            phases += [("prefill", to_ns(b.t_prefill), to_ns(b.t_prefilled)),
                       ("decode", to_ns(b.t_prefilled), to_ns(b.t_decoded))]
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps(phases)}
        stamps["trace_read"] = time.perf_counter()
        result["trace_in_batches"] = run.trace.share_inside(
            [(to_ns(b.t_prefill), to_ns(b.t_decoded)) for b in run.batches])
    metrics = {}
    for mname, (entry, read) in readers.items():
        value = read(run)
        if value is not None:
            metrics[mname] = {"value": value, "unit": entry["unit"]}

    failed = sum(1 for r in window.requests if not r.ok)
    sample = check.sample(window.requests, int(limits["sample_requests"]), seed)
    readings = check.served_gap(
        ref, model, params, [prompt(seed, r.index, PL, V) for r in sample],
        [r.tokens for r in sample], device, control=control)
    stamps["reference"] = time.perf_counter()
    gap_limit = float(limits["limits"]["logit_gap"])
    checks = {"logit_gap": {"value": readings["logit_gap"], "limit": gap_limit},
              "failed_requests": {"value": failed, "limit": 0}}
    correct = (readings["logit_gap"] <= gap_limit and failed == 0 and len(sample) > 0)
    device_info: dict[str, Any] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
    out = {"correct": bool(correct), "attempted": len(window.requests), "failed": failed,
           "metrics": metrics, "device": device_info, **result}
    if control is not None:
        out["control_gap"] = readings["control_gap"]
    out["seconds"] = {k: round(v - t_start, 3) for k, v in stamps.items()}
    out["check"] = checks
    return out


def power_limit() -> str:
    """The card's name and power limit from ``nvidia-smi`` ("" where absent)."""
    import subprocess

    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = registry.workload(registry.benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chipbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"chipbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    out["device"]["power_limit"] = power_limit()
    for key, c in out["check"].items():
        print(f"check {key}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
