"""Training the SSM archs (mamba2-1.3b; jamba-v0.1-52b, mamba and attention
sublayers with dense and MoE FFNs): the port's `lm_loss` (its parts) and
the gradient of every parameter (``A_log``, ``D`` and ``dt_bias`` in fp32
included), and one two-microbatch `make_train_step` step with AdamW,
against the live reference on the CPU at smoke size. Every gradient must
be finite: the SSD's segment sums hold -inf above the diagonal.

The bf16 case is Mamba2's. Jamba's 16 bf16 layers drift past the model
tolerance in the forward already (tests/test_torch_ssm.py holds them layer
by layer), and its embedding's gradient, which sums that drift, differs
from the reference's by up to 1.9 at a max of 5.2. Shared set-up and
tolerances: `tests/_torch_train.py`."""

import pytest

import _torch_train as TT

ARCHS = ("mamba2-1.3b", "jamba-v0.1-52b")


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("mamba2-1.3b", "bfloat16")])
def test_loss_and_grads_match_jax(arch, dtype):
    TT.check_loss_and_grads(TT.setup(arch, dtype))


def test_train_step_two_microbatches_matches_jax():
    TT.check_train_step(TT.setup("mamba2-1.3b", "float32"))
