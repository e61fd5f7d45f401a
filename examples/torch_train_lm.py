"""End-to-end training driver of the PyTorch/CUDA port: train a reduced
qwen2 on synthetic data for a few hundred steps with checkpointing and
fault tolerance, on the card (or ``--device cpu``).

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

(Thin wrapper over repro_torch.launch.train, as examples/train_lm.py is
over the reference's launcher; later arguments override the defaults.)
"""
import sys

from repro_torch.launch.train import main

if __name__ == "__main__":
    args = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "300",
            "--batch", "8", "--seq", "256", "--ckpt-every", "100"]
    args += sys.argv[1:]
    main(args)
