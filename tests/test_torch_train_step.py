"""``make_train_step`` of the port against the JAX package's on the CPU,
for reduced SmolLM-360M: 3 steps from the same weights on the same tokens
under every combination of microbatches {1, 2}, AdamW / Adafactor and int8
gradient compression off / on.  The metrics of every step (loss, xent,
aux, grad_norm, lr) and every leaf of the final state (parameters,
optimizer state, error feedback; shapes, dtypes and JAX's leaf order) are
compared within atol = rtol = 1e-4, with the looser budget
``train_compare.check_step_run`` gives Adafactor's bf16 first moment and
compressed runs, for the reasons given there.  The reference's step runs
under ``jax.jit``.
"""
import pytest

pytest.importorskip("jax")

from train_compare import check_step_run, run_both  # noqa: E402

VARIANTS = [(mb, fac, comp) for mb in (1, 2) for fac in (False, True)
            for comp in (False, True)]


@pytest.mark.parametrize(
    "microbatches,factored,compress", VARIANTS,
    ids=[f"mb{mb}-{'adafactor' if fac else 'adamw'}-"
         f"{'int8' if comp else 'fp32'}" for mb, fac, comp in VARIANTS])
def test_three_steps_equal_the_reference(microbatches, factored, compress):
    jm, js, tm, ts = run_both("smollm-360m", microbatches, factored,
                              compress)
    check_step_run(jm, js, tm, ts, factored, compress)
    assert tm[-1]["lr"] > 0 and tm[0]["lr"] == 0.0      # warmup from 0
