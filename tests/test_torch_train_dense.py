"""Training the dense archs: the port's `lm_loss` (its parts) and the
gradient of every parameter, and one two-microbatch `make_train_step` step
with AdamW, against the live reference (`repro.models.steps`) on the CPU at
smoke size. Shared set-up and tolerances: `tests/_torch_train.py`
(tests/test_torch_models.py's: fp32 2e-4; bf16 rtol 5e-2, atol 8e-2)."""

import pytest

import _torch_train as TT

ARCHS = ("qwen2-1.5b", "gemma-2b", "granite-8b", "stablelm-12b")


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("qwen2-1.5b", "bfloat16")])
def test_loss_and_grads_match_jax(arch, dtype):
    TT.check_loss_and_grads(TT.setup(arch, dtype))


def test_train_step_two_microbatches_matches_jax():
    TT.check_train_step(TT.setup("qwen2-1.5b", "float32"))
