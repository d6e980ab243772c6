#!/usr/bin/env python3
"""Measure the workspace a CUDA op allocates through the caching allocator
while it runs, beyond its outputs, on one GPU.

    python3 tools/workspace_calib.py [OUT.json]

For rows of 2¹² to 2²⁷ int32 elements: ``cumsum`` to int32 and to int64,
a stable ``sort`` along the row, ``searchsorted`` of 4,096 queries,
``nonzero``, ``gather`` and ``where``. Each op runs once to warm up, then
once between ``reset_peak_memory_stats`` and ``max_memory_allocated``;
the workspace is that peak less what was allocated before and less the
outputs' storages in 512-byte blocks. ``roofline.count.workspace`` models
``cumsum``'s and ``sort``'s from these numbers. The results are printed a
row at a time and written to ``OUT.json`` (default
``build/workspace_calib.json``), with the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SIZES = (1 << 12, 1 << 16, 1 << 20, 1 << 24, 1 << 27)


def transient(torch, fn, *inputs) -> int:
    torch.cuda.synchronize()
    out = fn(*inputs)
    del out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    outs = out if isinstance(out, (tuple, list)) else (out,)
    blocks = sum(-(-o.untyped_storage().nbytes() // 512) * 512 for o in outs)
    del out
    return peak - base - blocks


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("workspace_calib: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    ops = {
        "cumsum_i32_to_i32": lambda x: torch.cumsum(x, 1, dtype=torch.int32),
        "cumsum_i32_to_i64": lambda x: torch.cumsum(x, 1),
        "sort_stable_i32": lambda x: torch.sort(x, dim=1, stable=True),
        "searchsorted": lambda x: torch.searchsorted(
            x, x[:, :4096], out_int32=True),
        "nonzero": lambda x: (x[0] > 500).nonzero(),
        "gather": lambda x: torch.gather(x, 1, x[:, :4096].long()),
        "where": lambda x: torch.where(x > 3, x, 0),
    }
    res = {}
    for n in SIZES:
        x = torch.randint(0, 1000, (1, n), dtype=torch.int32, device=dev)
        xs = torch.sort(x, 1).values
        row = {k: transient(torch, f, xs if k == "searchsorted" else x)
               for k, f in ops.items()}
        res[n] = row
        print(n, json.dumps(row), flush=True)
        del x, xs
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = Path(sys.argv[1] if len(sys.argv) > 1 else "build/workspace_calib.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, torch=torch.__version__,
                                   rows=res), indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
