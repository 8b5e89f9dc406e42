"""Serving launcher: continuous-batching engine over synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --reduced --requests 16 --max-batch 4 --device cpu

``--arch`` takes every decoder-only config: the dense ones, the MoE ones
(``kimi-k2-1t-a32b``, ``llama4-scout-17b-a16e``), the VLM's text
(``internvl2-2b``), ``zamba2-1.2b`` (hybrid) and ``rwkv6-1.6b`` (RWKV6).
``whisper-base`` (enc-dec) exits with a message, as the JAX launcher does:
its serving needs the frames feed (``EncDecLM.prefill`` then
``decode_step``).

Runs on the card (``--device cuda``, the default) unless asked for the CPU;
params are drawn from a generator seeded with ``--seed``.  Prints the
engine's ``stats()`` as one JSON line.
"""
import argparse
import json

import numpy as np

from ..configs import ARCH_IDS, get_config
from ..models import build_model
from ..serve import Request, ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family == "encdec":
        raise SystemExit("enc-dec serving needs the frames feed; use the "
                         "decoder-only archs for this launcher")
    model = build_model(cfg, device=args.device, seed=args.seed)
    eng = ServeEngine(model, ServeConfig(max_batch=args.max_batch,
                                         max_len=args.max_len))
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens))
    eng.run_until_drained()
    print(json.dumps(eng.stats()))


if __name__ == "__main__":
    main()
