#!/usr/bin/env python3
"""How ``chip_smoke.py``'s ``sparse_train`` parity behaves at ReLU kinks.

    python3 probe_sparse_parity.py [--runs 12]     # one CUDA card

SECOND's sparse encoder (``chip_smoke.SECOND``) takes its batch-1 step on
the card and on the CPU from the same weights, scan and target
(``chip_smoke.drive_sparse_parity``), with TF32 off.  The scan's
features are multiplied by ``1 ± 2^-23`` at random signs (one rounding
step each, ``RandomState(7)``) ``--runs`` times; each run compares the
card with the CPU twice: with the CPU on its own ReLU masks (``own``) and
on the card's (``card``, what the phase holds).  A ReLU input within
rounding of 0 can fall on either side on the two devices, and the
gradients then differ by that site's whole term, which only ``own``
sees.  Prints one JSON line a run (``own`` and ``card``: the BEV map's
error, the worst gradient's name and error, each relative to the CPU's
largest magnitude; ``card`` also the flipped ReLU inputs a layer and
their largest magnitude relative to their layer's largest), then one
line with TF32 on (``own``), then the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402


def summary(p: dict, flips: bool = False) -> dict:
    g = p["grad_rel_err"]
    worst = max(g, key=g.get)
    out = {"bev_rel_err": p["bev_rel_err"], "worst_grad": worst,
           "grad_rel_err": g[worst], "differing_layers":
           p["differing_layers"]}
    if flips:
        out.update(relu_flips=p["relu_flips"],
                   relu_flip_rel=p["relu_flip_rel"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_sparse_parity: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.SECOND
    idx, feats = cs.scan_batch(cfg, 1, 16000, seed=100)
    r = np.random.RandomState(7)
    for i in range(args.runs):
        f = (feats * (1 + r.choice([-1, 1], feats.shape) * 2.0 ** -23)
             ).astype(np.float32)
        row = {"run": i}
        for name, follow in (("own", False), ("card", True)):
            row[name] = summary(cs.drive_sparse_parity(
                cfg, 16000, "cuda", scan=(idx, f), follow_masks=follow),
                flips=follow)
        print(json.dumps(row), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        print(json.dumps({"tf32_matmul": summary(cs.drive_sparse_parity(
            cfg, 16000, "cuda", follow_masks=False))}), flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
