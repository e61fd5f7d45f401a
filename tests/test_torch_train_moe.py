"""Training the MoE archs (qwen2-moe-a2.7b; deepseek-v2-lite-16b, whose
attention is MLA and whose first layer is dense): the port's `lm_loss`
(its parts, the router's aux loss among them) and the gradient of every
parameter, the fp32 router's included, and one two-microbatch
`make_train_step` step with AdamW, against the live reference on the CPU
at smoke size, through the capacity dispatch (the configs' default).
Shared set-up and tolerances: `tests/_torch_train.py`."""

import pytest

import _torch_train as TT

ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b")


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("qwen2-moe-a2.7b", "bfloat16")])
def test_loss_and_grads_match_jax(arch, dtype):
    TT.check_loss_and_grads(TT.setup(arch, dtype))


def test_train_step_two_microbatches_matches_jax():
    TT.check_train_step(TT.setup("qwen2-moe-a2.7b", "float32"))
