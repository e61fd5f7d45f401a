"""Batched serving example of the PyTorch/CUDA port: prefill + decode a
small model with batched requests, reporting TTFT and tokens/s, on the card
(or ``--device cpu``).

  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]

(Thin wrapper over repro_torch.launch.serve, as examples/serve_decode.py is
over the reference's launcher; later arguments override the defaults.)
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    args = ["--arch", "gemma-2b", "--smoke", "--requests", "8",
            "--batch", "4", "--prompt-len", "64", "--gen-len", "16"]
    args += sys.argv[1:]
    main(args)
