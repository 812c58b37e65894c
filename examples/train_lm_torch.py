"""End-to-end driver: train an LM with the full framework stack, on the
PyTorch port.

The counterpart of ``examples/train_lm.py`` on ``repro_torch``: it wraps
the port's production entry point (``repro_torch.launch.train``): the
train step (AdamW, remat, microbatches), the proxy-fed data pipeline,
async proxy-backed checkpoints and crash/restart.  Defaults train the
*reduced* config; pass ``--full --arch mamba2-130m`` to train the real
~130M-parameter model.  The tokens follow a Zipf law
(``train.data.zipf_batch``), a unigram distribution the model learns, so
the loss visibly falls; the driver's own uniform tokens leave nothing to
learn (a fresh model sits within about 0.01 of log V).  Without
``--run-dir`` each run starts fresh in a temporary directory; give one to
checkpoint there and resume on the next run.

Runs on the GPU unless ``--device cpu`` is given:

    PYTHONPATH=src python examples/train_lm_torch.py --steps 60
    PYTHONPATH=src python examples/train_lm_torch.py --steps 60 --device cpu
"""

from __future__ import annotations

import sys
import tempfile

from repro_torch.launch.train import parse_args, train
from repro_torch.train.data import zipf_batch


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--full" in argv:
        argv.remove("--full")
    else:
        argv = ["--smoke", "--batch", "8", "--seq", "128",
                "--ckpt-every", "25", "--log-every", "5"] + argv
    with tempfile.TemporaryDirectory() as run_dir:
        if "--run-dir" not in argv:
            argv += ["--run-dir", run_dir]
        out = train(parse_args(argv), sample=zipf_batch)
    final = out["final"]
    print(f"\nfinal: step={final['step']} loss={final['loss']:.4f} "
          f"tokens/s={final['tokens_per_s']:,.0f}")
    first, last = out["log"][0], out["log"][-1]
    assert last["loss"] < first["loss"], "loss did not decrease!"
    print("loss decreased:", round(first["loss"], 3), "->", round(last["loss"], 3))
    return out


if __name__ == "__main__":
    main()
