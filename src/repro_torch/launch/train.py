"""End-to-end LM training driver: the twin of ``repro.launch.train``, on
the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/run1 --device cpu

Weights from ``threefry.prng_key(seed)``, batches from ``lm_batch(seed,
step, ...)``: the reference's for the same seed. Production behaviours, as
in the reference:
  * checkpoint/restart — rolling async checkpoints in the reference's
    format; ``--restore`` resumes bit for bit from the manifest's step
    (the token stream is a function of the step);
  * preemption — SIGTERM/SIGINT trigger a final blocking checkpoint;
  * straggler watchdog — EWMA step-time outlier flagging;
  * gradient compression — ``--compress`` int8 + error feedback;
  * grad accumulation — ``--accum N`` (the microbatches a leading axis).
It prints the reference's lines; step walls end in a synchronize. Run as
a program it sets the caching allocator's expandable segments (unless
``PYTORCH_CUDA_ALLOC_CONF`` says otherwise): a full-width step's loss
allocates and frees float32 logits of [batch, seq, vocab] among smaller
tensors, and fixed segments split by the smaller ones leave no room for
the next large one.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np

from repro_torch import configs as registry
from repro_torch.checkpoint import CheckpointManager
from repro_torch.comm import make_int8_compressor
from repro_torch.data import lm_batch
from repro_torch.models import threefry
from repro_torch.models import transformer as TF
from repro_torch.train import adafactor, adamw, make_train_step
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.trainer import init_state
from repro_torch.utils import resolve_device, sync


def main(argv=None, keep: dict | None = None):
    """Train as the flags say; the mean losses of the first and last
    tenth of the steps run.

    ``keep``, where given, receives ``cfg``, ``losses`` (every step's
    loss, as it runs) and ``state`` (the latest ``TrainState``), so that a
    caller can check the run without training again."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mod = registry.get_arch(args.arch)
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    opt = adafactor(args.lr) if getattr(mod, "OPTIMIZER", "adamw") == "adafactor" \
        else adamw(args.lr)

    params = TF.init_params(cfg, threefry.prng_key(args.seed), dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"vocab={cfg.vocab} layers={cfg.n_layers}")

    state = init_state(params, opt, compression=args.compress)
    del params
    step_fn = make_train_step(
        lambda p, b: TF.loss_fn(cfg, p, b), opt, accum_steps=args.accum,
        grad_transform=make_int8_compressor() if args.compress else None)

    start_step = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.restore and mgr.latest_step() is not None:
        state, extra = mgr.restore_latest(state)
        start_step = extra["step"]
        print(f"restored step {start_step} from {args.ckpt_dir}")

    losses = []
    if keep is not None:
        keep.update(cfg=cfg, losses=losses, state=state)
    stop = {"now": False}

    def _sig(_s, _f):
        print("preemption signal: checkpointing and exiting")
        stop["now"] = True

    previous = {s: signal.signal(s, _sig) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        ewma = None
        for i in range(start_step, args.steps):
            batch = lm_batch(args.seed, i, args.batch, args.seq, cfg.vocab, dev)
            if args.accum > 1:
                batch = batch.reshape(args.accum, args.batch // args.accum,
                                      args.seq)
            sync(dev)
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            loss = float(m["loss"])
            sync(dev)
            dt = time.perf_counter() - t0
            losses.append(loss)
            if keep is not None:
                keep["state"] = state
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > 3.0 * ewma and i > start_step + 3:
                print(f"[straggler] step {i} took {dt:.2f}s (ewma {ewma:.2f}s)")
            if i % args.log_every == 0:
                tok_s = args.batch * args.seq / dt
                print(f"step {i:5d} loss {loss:.4f} {dt*1e3:7.1f} ms "
                      f"{tok_s:9.0f} tok/s")
            if mgr and (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, state, extra=dict(seed=args.seed))
            if stop["now"]:
                if mgr:
                    mgr.save(i + 1, state, extra=dict(seed=args.seed),
                             block=True)
                sys.exit(0)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)

    if mgr:
        mgr.save(args.steps, state, extra=dict(seed=args.seed), block=True)
        mgr.close()
    first = np.mean(losses[: max(1, len(losses) // 10)])
    last = np.mean(losses[-max(1, len(losses) // 10):])
    print(f"done: loss {first:.4f} → {last:.4f}")
    return first, last


if __name__ == "__main__":
    import os

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    main()
