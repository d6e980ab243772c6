"""End-to-end LM training: a same-family model trained for a few hundred
steps with checkpointing, through the port's train driver
(:func:`repro_torch.launch.train.main`); the twin of
``examples/train_lm.py``.

The default trains internlm2's ``SMOKE`` model (200 steps, batch 8 × 128
tokens, a checkpoint every 50); ``--hundred-m`` trains the example's own
80,032,256-parameter float32 config (:data:`HUNDRED_M`: 12 layers × d 512
× d_ff 2,048 over the internlm2 family, batch 8 × 256 tokens), sized for
the card. Checkpoints go to ``--ckpt-dir``, or to a temporary directory
removed afterwards (the twin's default is a fixed ``/tmp`` path).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \
        [--hundred-m] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile

from repro_torch import configs as registry
from repro_torch.configs.base import LMConfig
from repro_torch.launch import train as train_mod

ARCH = "internlm2-1.8b"
HUNDRED_M = LMConfig(name="internlm2-100m", n_layers=12, d_model=512,
                     n_heads=8, n_kv_heads=4, d_ff=2048, vocab=32064,
                     dtype="float32", param_dtype="float32", attn_chunk=256)


@contextlib.contextmanager
def as_smoke(cfg: LMConfig):
    """internlm2's ``SMOKE`` is ``cfg`` inside the block, so that the
    train driver's ``--smoke`` trains it (the twin sets it the same way);
    the module's own ``SMOKE`` is put back afterwards."""
    mod = registry.get_arch(ARCH)
    saved = mod.SMOKE
    mod.SMOKE = cfg
    try:
        yield
    finally:
        mod.SMOKE = saved


def driver_argv(steps: int, hundred_m: bool, ckpt_dir: str) -> list:
    """The train driver's flags for this example (the twin's)."""
    return ["--arch", ARCH, "--smoke", "--steps", str(steps), "--batch", "8",
            "--seq", "256" if hundred_m else "128", "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "50"]


def main(argv=None, device=None) -> dict:
    """Train as the flags say (``argv``; ``None``: the defaults) on
    ``device`` (``None``: ``--device``, else the card); the first and last
    tenths' mean losses and every step's loss. Raises if the loss did not
    fall."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device, e.g. cpu (default: the CUDA device)")
    args = ap.parse_args([] if argv is None else argv)
    device = device if device is not None else args.device

    keep = {}
    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory())
        if args.hundred_m:
            stack.enter_context(as_smoke(HUNDRED_M))
        flags = driver_argv(args.steps, args.hundred_m, ckpt_dir)
        if device is not None:
            flags += ["--device", str(device)]
        first, last = train_mod.main(flags, keep=keep)
    if not last < first:
        raise RuntimeError(f"loss did not improve: {first} → {last}")
    return dict(first=float(first), last=float(last),
                losses=list(keep["losses"]))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
