"""Serving launcher: M model replicas behind the QEdgeProxy router.

Port of ``repro/launch/serve.py``. Each replica is a ``ServingEngine``
(here they share one device and one set of weights but carry distinct
emulated network distances); K front-ends send request microbatches;
the router learns per-replica QoS success probabilities and SWRR-routes
to meet (tau, rho, W). Unlike the reference launcher, which always
serves the reduced model, this one serves the published config unless
``--smoke`` is given.

Each microbatch is built by family (``request_batch``): the tokens
alone for the decoders; Whisper's encoder frames (``cross_kv_len`` of
them) beside a ``--prompt-len``-token decoder prompt, decoded from
position ``prompt_len`` (the launcher refuses a run whose decode would
pass ``max_decode_len``); the VLM's ``num_patches`` patch embeddings
before the prompt, decoded from position ``num_patches + prompt_len``,
its caches counting the patches. The reference launcher sends the
tokens alone, which the Whisper and VLM models cannot take.

  python -m repro_torch.launch.serve --replicas 3 --frontends 4 \\
      --requests 30 --batch 4 --prompt-len 1000 --decode-steps 16 \\
      --tau 1.0 --slow-replica 2                       # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --smoke --device cpu --prompt-len 4   # within max_decode_len (32)

The last line of output is one JSON object with the run's counts and
per-call times (host clock, each call ending in a device synchronize).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, AUDIO, VLM, ModelConfig, get_config
from repro_torch.core import BanditParams
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import QEdgeRouter, ServingEngine


def decode_start(cfg: ModelConfig, prompt_len: int) -> int:
    """The position of the first decode token after a prompt of
    ``prompt_len`` tokens: after the VLM's patches too."""
    return prompt_len + (cfg.num_patches if cfg.family == VLM else 0)


def request_batch(cfg: ModelConfig, prompt: torch.Tensor,
                  gen: torch.Generator) -> dict:
    """The model's batch for the prompt tokens (B, S), its stub frontend
    inputs drawn from ``gen`` on the prompt's device: Whisper's frames
    (B, cross_kv_len, d), the VLM's patches (B, num_patches, d); float32,
    the model casts them."""
    if cfg.family not in (AUDIO, VLM):
        return {"tokens": prompt}
    n, key = ((cfg.cross_kv_len, "frames") if cfg.family == AUDIO
              else (cfg.num_patches, "patches"))
    stub = torch.randn((prompt.shape[0], n, cfg.d_model), generator=gen,
                       device=prompt.device)
    return {key: stub, "tokens": prompt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config instead of the published one")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--frontends", type=int, default=4)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--tau", type=float, default=0.5)
    ap.add_argument("--slow-replica", type=int, default=-1,
                    help="index of a replica with +tau extra latency")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.smoke)
    if (cfg.family == AUDIO
            and args.prompt_len + args.decode_steps > cfg.max_decode_len):
        raise ValueError(f"{cfg.name} decodes at most {cfg.max_decode_len} "
                         f"positions: prompt {args.prompt_len} + "
                         f"{args.decode_steps} decode steps")
    model = build_model(cfg, device=dev)
    first = decode_start(cfg, args.prompt_len)
    max_len = first + args.decode_steps

    engines = []
    for m in range(args.replicas):
        extra = args.tau if m == args.slow_replica else 0.0
        engines.append(ServingEngine(model, max_len, extra))

    router = QEdgeRouter(
        args.frontends, args.replicas,
        BanditParams(tau=args.tau, rho=0.9, window=30.0, cooldown=5.0),
        device=dev)

    ok = total = maint = 0
    prefill_s, decode_s, finite = [], [], True
    t_last_maint = time.monotonic()
    for r in range(args.requests):
        choices = router.route()
        lats = np.zeros(args.frontends)
        for k, m in enumerate(choices):
            gen = torch.Generator(device=dev).manual_seed(r * 131 + k)
            prompt = torch.randint(0, cfg.vocab_size,
                                   (args.batch, args.prompt_len),
                                   generator=gen, device=dev)
            logits, cache, lat_p = engines[m].prefill(
                request_batch(cfg, prompt, gen))
            finite &= bool(logits.isfinite().all())
            prefill_s.append(lat_p - engines[m].extra_latency)
            lat = lat_p
            tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)
            for i in range(args.decode_steps):
                logits, cache, lat_d = engines[m].decode(cache, tok,
                                                         first + i)
                finite &= bool(logits.isfinite().all())
                decode_s.append(lat_d - engines[m].extra_latency)
                lat += lat_d
            lats[k] = lat
            total += 1
            ok += int(lat <= args.tau)
        router.feedback(choices, lats)
        if time.monotonic() - t_last_maint > 1.0:
            router.maintenance()
            maint += 1
            t_last_maint = time.monotonic()
        if r == args.requests // 2 and args.slow_replica >= 0:
            print(f"[{r}] weights:\n{router.weights.round(3)}")

    router.maintenance()
    maint += 1
    print(f"QoS success: {ok}/{total} = {100*ok/max(total,1):.1f}% "
          f"(tau={args.tau}s)")
    print("final routing weights (frontends x replicas):")
    print(router.weights.round(3))
    print("replica QoS estimates:")
    print(router.qos_estimates.round(3))
    print(json.dumps({
        "arch": cfg.name, "device": str(dev), "microbatches": total,
        "qos_ok": ok, "prefills": len(prefill_s), "decodes": len(decode_s),
        "maintenance_calls": maint, "logits_finite": finite,
        "prefill_s": prefill_s, "decode_s": decode_s}))
    return router


if __name__ == "__main__":
    main()
