"""Continuous-batching serving demo, on the PyTorch port: requests of
different lengths share decode slots; each stream is what standalone
generation gives.

The port of ``examples/continuous_batching.py`` (qwen2-1.5b reduced to 2
layers and a vocabulary of 128, random weights from seed 0, a
``ServingEngine`` with 2 slots and a 48-row cache). It computes on
``--device`` (default ``cuda``); without a GPU it exits non-zero unless
given ``--device cpu``. It ends with PASS when every request finished
with its 8 tokens, and exits non-zero otherwise.

    python examples_torch/continuous_batching.py
    python examples_torch/continuous_batching.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.runtime.devices import resolve_device
from repro_torch.serving import ServingEngine

PROMPTS = [[5, 9, 2], [7], [11, 3, 3, 1], [42, 17]]
NEW_TOKENS = 8
MAX_STEPS = 200


def config():
    return get_config("qwen2-1.5b").reduced(num_layers=2, vocab_size=128)


def serve(cfg, params, device, log=print):
    """Submit ``PROMPTS`` to a 2-slot engine and step it until every
    request is done (at most ``MAX_STEPS`` steps). Returns ({uid: tokens},
    engine steps)."""
    eng = ServingEngine(cfg, params, max_slots=2, cache_len=48,
                        device=device)
    uids = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in PROMPTS]
    log(f"submitted {len(PROMPTS)} requests into {eng.max_slots} slots")

    steps = 0
    done = {}
    while len(done) < len(uids) and steps < MAX_STEPS:
        for r in eng.step():
            done[r.uid] = r.generated
            log(f"  step {steps:3d}: request {r.uid} finished -> "
                f"{r.generated}")
        steps += 1
    log(f"drained in {steps} engine steps "
        f"(token-level interleaving across slots)")
    return done, steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu); without a GPU only "
                         "--device cpu runs")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    cfg = config()
    params = model_lib.init_params(0, cfg, device=device)
    done, _ = serve(cfg, params, device)
    ok = (len(done) == len(PROMPTS)
          and all(len(t) == NEW_TOKENS for t in done.values()))
    print("PASS" if ok else "FAIL: not every request finished")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
