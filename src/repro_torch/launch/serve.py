"""Batched serving driver: prefill + greedy decode with a KV cache.

The twin of ``repro.launch.serve``, on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
        --smoke --batch 4 --prompt-len 32 --gen 32 --device cpu

Weights from ``threefry.prng_key(seed)``, prompts from ``lm_batch(seed,
1, ...)``: the reference's for the same seed. It prints the reference's
three lines (walls end in a synchronize) and returns the generated token
ids [batch, gen] as numpy.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch import configs as registry
from repro_torch.data import lm_batch
from repro_torch.models import threefry
from repro_torch.models import transformer as TF
from repro_torch.utils import resolve_device, sync


def prefill(cfg, params, prompts, max_len: int):
    """Run the prompts once: their logits [B, S, V] and the KV cache,
    padded to ``max_len`` positions, at position S."""
    B, S = prompts.shape
    logits, extras = TF.forward(cfg, params, prompts, return_cache=True)
    pad = (0, 0, 0, 0, 0, max_len - S)
    cache = dict(k=F.pad(extras["cache"]["k"], pad),
                 v=F.pad(extras["cache"]["v"], pad),
                 pos=torch.full((B,), S, dtype=torch.int32,
                                device=prompts.device))
    return logits, cache


def greedy(logits):
    """The first largest logit's index, int32 (``jnp.argmax``)."""
    return torch.argmax(logits, -1).to(torch.int32)


def main(argv=None, keep: dict | None = None):
    """Serve one batch as the flags say; the token ids [batch, gen].

    ``keep``, where given, receives what was served: ``cfg``, ``params``,
    ``prompts`` and ``logits``, the list of the prefill's last-position
    logits and each decode step's ([batch, 1, vocab] each), so that a
    caller can check the run without drawing the weights again."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mod = registry.get_arch(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    with torch.inference_mode():
        params = TF.init_params(cfg, threefry.prng_key(args.seed), dev)
        max_len = args.prompt_len + args.gen
        prompts = lm_batch(args.seed, 1, args.batch, args.prompt_len,
                           cfg.vocab, dev)

        sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(cfg, params, prompts, max_len)
        tok = greedy(logits[:, -1:])
        sync(dev)
        t_prefill = time.perf_counter() - t0

        out = [tok]
        kept = None if keep is None else [logits[:, -1:].clone()]
        t1 = time.perf_counter()
        for _ in range(args.gen - 1):
            logits, cache = TF.decode_step(cfg, params, cache, tok)
            tok = greedy(logits)
            out.append(tok)
            if keep is not None:
                kept.append(logits)
        sync(dev)
        t_dec = time.perf_counter() - t1
        seqs = torch.cat(out, 1).cpu().numpy()
        if keep is not None:
            keep.update(cfg=cfg, params=params, prompts=prompts, logits=kept)
    print(f"prefill: {args.batch}×{args.prompt_len} in {t_prefill*1e3:.1f} ms "
          f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")
    print(f"decode: {args.gen-1} steps × batch {args.batch} in {t_dec*1e3:.1f} ms "
          f"({args.batch*(args.gen-1)/max(t_dec,1e-9):.0f} tok/s)")
    print(f"sample continuation ids: {seqs[0][:16].tolist()}")
    return seqs


if __name__ == "__main__":
    main()
