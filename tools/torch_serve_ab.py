#!/usr/bin/env python3
"""Serve Qwen2-1.5B at full width from two checkouts of the PyTorch/CUDA
port, in turns, on one GPU: the A/B comparison of two commits' serving
metrics within one machine.

    python3 tools/torch_serve_ab.py PARENT_DIR CHANGE_DIR [--order pccppc]

``--order`` spells the turns, ``p`` for PARENT_DIR and ``c`` for CHANGE_DIR
(default ``pccppc``). Each turn is a fresh process that builds the
checkout's kernels and serves 8 requests in batches of 4, prompt 1024, 32
generated tokens, as ``chip_smoke.py`` does; being cold, its first batch
pays the first cuBLAS calls. Each turn prints one line: ``AB``, the side,
the launcher's report as JSON and the kernel launch counts.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

SERVE_ARGS = ["--arch", "qwen2-1.5b", "--requests", "8", "--batch", "4",
              "--prompt-len", "1024", "--gen-len", "32", "--device", "cuda"]


def one_turn(root: pathlib.Path, side: str) -> None:
    """Serve once from the checkout at root (this process imports it)."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _build, launch
    from repro_torch.launch import serve
    _build.build()
    launch.reset_launches()
    report = serve.main(SERVE_ARGS, record={})
    print("AB", side, json.dumps(report), json.dumps(dict(launch.LAUNCHES)),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=pathlib.Path)
    ap.add_argument("change", type=pathlib.Path)
    ap.add_argument("--order", default="pccppc")
    ap.add_argument("--turn", choices=("p", "c"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    roots = {"p": args.parent.resolve(), "c": args.change.resolve()}
    if args.turn:
        one_turn(roots[args.turn], {"p": "parent", "c": "change"}[args.turn])
        return 0
    if not args.order or set(args.order) - set(roots):
        ap.error(f"--order spells turns with p and c, got {args.order!r}")
    for side in args.order:
        proc = subprocess.run([sys.executable, __file__, str(roots["p"]),
                               str(roots["c"]), "--turn", side],
                              capture_output=True, text=True, check=False)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("AB ")]
        if proc.returncode or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode or 1
        print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
